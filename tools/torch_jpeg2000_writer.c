/* Writes a JPEG 2000 file with the system's OpenJPEG (libopenjp2.so.7),
 * installed without its development headers: the few declarations it needs are
 * written out below from openjpeg.h (2.5), and the parameter block's layout
 * is checked against the defaults the library sets before it is used.
 * It reaches what Pillow's keyword arguments do not: code-block styles,
 * SOP/EPH, POC, an ROI shift, subsampled components, tile-parts, an image
 * offset, PLT and TLM. tests/torch_jpeg2000_writers.opj_file builds and
 * calls it:
 *
 *   torch_jpeg2000_writer in.raw out.j2k|jp2 W H C PREC JP2 [key=value ...]
 *
 * in.raw: C planes of H x W int32. Keys: numres, cblk=w,h, prec_size=w,h,
 * mode (code-block style bits), csty (2 SOP, 4 EPH), prog (LRCP..CPRL),
 * irreversible, mct, rates=r1,r2,.. (layers; 0 lossless), tile=w,h,
 * offset=x0,y0, subsampling=dx,dy (components after the first),
 * roi=comp,shift, poc=PROG,res0,comp0,lay1,res1,comp1;..., tp=R|L|C,
 * plt=1, tlm=1.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef int OPJ_BOOL;
typedef enum { PROG_UNKNOWN = -1, LRCP = 0, RLCP, RPCL, PCRL, CPRL } PROG;

typedef struct {
    uint32_t resno0, compno0, layno1, resno1, compno1, layno0, precno0, precno1;
    PROG prg1, prg;
    char progorder[5];
    uint32_t tile;
    int32_t tx0, tx1, ty0, ty1;
    uint32_t layS, resS, compS, prcS, layE, resE, compE, prcE;
    uint32_t txS, txE, tyS, tyE, dx, dy;
    uint32_t lay_t, res_t, comp_t, prc_t, tx0_t, ty0_t;
} opj_poc_t;

typedef struct {
    OPJ_BOOL tile_size_on;
    int cp_tx0, cp_ty0, cp_tdx, cp_tdy;
    int cp_disto_alloc, cp_fixed_alloc, cp_fixed_quality;
    int* cp_matrice;
    char* cp_comment;
    int csty;
    PROG prog_order;
    opj_poc_t POC[32];
    uint32_t numpocs;
    int tcp_numlayers;
    float tcp_rates[100];
    float tcp_distoratio[100];
    int numresolution, cblockw_init, cblockh_init, mode, irreversible;
    int roi_compno, roi_shift, res_spec;
    int prcw_init[33], prch_init[33];
    char infile[4096], outfile[4096];
    int index_on;
    char index[4096];
    int image_offset_x0, image_offset_y0, subsampling_dx, subsampling_dy;
    int decod_format, cod_format;
    OPJ_BOOL jpwl_epc_on;
    int jpwl_hprot_MH, jpwl_hprot_TPH_tileno[16], jpwl_hprot_TPH[16];
    int jpwl_pprot_tileno[16], jpwl_pprot_packno[16], jpwl_pprot[16];
    int jpwl_sens_size, jpwl_sens_addr, jpwl_sens_range, jpwl_sens_MH;
    int jpwl_sens_TPH_tileno[16], jpwl_sens_TPH[16];
    int cp_cinema, max_comp_size, cp_rsiz;
    char tp_on, tp_flag, tcp_mct;
    OPJ_BOOL jpip_on;
    void* mct_data;
    int max_cs_size;
    uint16_t rsiz;
    char spare[4096];   /* room should the library's block be larger */
} opj_cparameters_t;

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd;
} opj_image_cmptparm_t;

typedef struct {
    uint32_t dx, dy, w, h, x0, y0, prec, bpp, sgnd, resno_decoded, factor;
    int32_t* data;
    uint16_t alpha;
} opj_image_comp_t;

typedef struct {
    uint32_t x0, y0, x1, y1, numcomps;
    int color_space;
    opj_image_comp_t* comps;
    unsigned char* icc_profile_buf;
    uint32_t icc_profile_len;
} opj_image_t;

void opj_set_default_encoder_parameters(opj_cparameters_t*);
void* opj_create_compress(int format);
OPJ_BOOL opj_setup_encoder(void*, opj_cparameters_t*, opj_image_t*);
OPJ_BOOL opj_encoder_set_extra_options(void*, const char* const*);
opj_image_t* opj_image_create(uint32_t, opj_image_cmptparm_t*, int);
void opj_image_destroy(opj_image_t*);
void* opj_stream_create_default_file_stream(const char*, OPJ_BOOL);
void opj_stream_destroy(void*);
OPJ_BOOL opj_start_compress(void*, opj_image_t*, void*);
OPJ_BOOL opj_encode(void*, void*);
OPJ_BOOL opj_end_compress(void*, void*);
void opj_destroy_codec(void*);

static PROG prog_of(const char* s) {
    const char* names[] = {"LRCP", "RLCP", "RPCL", "PCRL", "CPRL"};
    for (int i = 0; i < 5; ++i)
        if (!strncmp(s, names[i], 4)) return (PROG)i;
    return PROG_UNKNOWN;
}

static int pair(const char* s, int* a, int* b) { return sscanf(s, "%d,%d", a, b) == 2; }

int main(int argc, char** argv) {
    if (argc < 8) {
        fprintf(stderr, "usage: %s in.raw out W H C PREC JP2 [key=value ...]\n", argv[0]);
        return 2;
    }
    int w = atoi(argv[3]), h = atoi(argv[4]), c = atoi(argv[5]), prec = atoi(argv[6]);
    int jp2 = atoi(argv[7]);
    opj_cparameters_t p;
    opj_set_default_encoder_parameters(&p);
    if (p.numresolution != 6 || p.cblockw_init != 64 || p.roi_compno != -1 ||
        p.subsampling_dx != 1 || p.decod_format != -1 || p.cod_format != -1) {
        fprintf(stderr, "the parameter block's layout differs from this library's\n");
        return 3;
    }
    p.tcp_numlayers = 1;
    p.tcp_rates[0] = 0;
    p.cp_disto_alloc = 1;
    p.tcp_mct = c >= 3 ? 1 : 0;
    int x0 = 0, y0 = 0, sdx = 1, sdy = 1, plt = 0, tlm = 0;
    for (int i = 8; i < argc; ++i) {
        char* eq = strchr(argv[i], '=');
        if (!eq) return 2;
        *eq = 0;
        const char *k = argv[i], *v = eq + 1;
        if (!strcmp(k, "numres")) p.numresolution = atoi(v);
        else if (!strcmp(k, "cblk")) pair(v, &p.cblockw_init, &p.cblockh_init);
        else if (!strcmp(k, "prec_size")) {
            int a, b;
            pair(v, &a, &b);
            p.res_spec = 1;
            p.prcw_init[0] = a;
            p.prch_init[0] = b;
            p.csty |= 1;
        } else if (!strcmp(k, "mode")) p.mode = atoi(v);
        else if (!strcmp(k, "csty")) p.csty |= atoi(v);
        else if (!strcmp(k, "prog")) p.prog_order = prog_of(v);
        else if (!strcmp(k, "irreversible")) p.irreversible = atoi(v);
        else if (!strcmp(k, "mct")) p.tcp_mct = (char)atoi(v);
        else if (!strcmp(k, "rates")) {
            int n = 0;
            for (const char* s = v; s && *s; ++n) {
                p.tcp_rates[n] = (float)atof(s);
                s = strchr(s, ',');
                if (s) ++s;
            }
            p.tcp_numlayers = n;
        } else if (!strcmp(k, "tile")) {
            pair(v, &p.cp_tdx, &p.cp_tdy);
            p.tile_size_on = 1;
        } else if (!strcmp(k, "offset")) pair(v, &x0, &y0);
        else if (!strcmp(k, "subsampling")) pair(v, &sdx, &sdy);
        else if (!strcmp(k, "roi")) pair(v, &p.roi_compno, &p.roi_shift);
        else if (!strcmp(k, "poc")) {
            const char* s = v;
            while (s && *s && p.numpocs < 32) {
                opj_poc_t* q = &p.POC[p.numpocs++];
                char prog[5] = {0};
                int r0, c0, l1, r1, c1;
                if (sscanf(s, "%4[A-Z],%d,%d,%d,%d,%d", prog, &r0, &c0, &l1, &r1, &c1) != 6)
                    return 2;
                q->tile = 1;
                q->resno0 = r0;
                q->compno0 = c0;
                q->layno1 = l1;
                q->resno1 = r1;
                q->compno1 = c1;
                q->prg1 = prog_of(prog);
                s = strchr(s, ';');
                if (s) ++s;
            }
        } else if (!strcmp(k, "tp")) {
            p.tp_on = 1;
            p.tp_flag = v[0];
        } else if (!strcmp(k, "plt")) plt = atoi(v);
        else if (!strcmp(k, "tlm")) tlm = atoi(v);
        else return 2;
    }
    opj_image_cmptparm_t cp[4];
    memset(cp, 0, sizeof cp);
    for (int i = 0; i < c; ++i) {
        cp[i].dx = i ? sdx : 1;
        cp[i].dy = i ? sdy : 1;
        cp[i].w = i ? (w + sdx - 1) / sdx : w;
        cp[i].h = i ? (h + sdy - 1) / sdy : h;
        cp[i].x0 = x0;
        cp[i].y0 = y0;
        cp[i].prec = prec;
        cp[i].bpp = prec;
    }
    opj_image_t* img = opj_image_create(c, cp, c >= 3 ? 1 : 2);   /* sRGB or gray */
    if (!img) return 4;
    img->x0 = x0;
    img->y0 = y0;
    img->x1 = x0 + w;
    img->y1 = y0 + h;
    FILE* f = fopen(argv[1], "rb");
    if (!f) return 4;
    for (int i = 0; i < c; ++i) {
        int32_t* plane = malloc(sizeof(int32_t) * w * h);
        if (fread(plane, sizeof(int32_t), (size_t)w * h, f) != (size_t)w * h) return 4;
        for (uint32_t y = 0; y < img->comps[i].h; ++y)
            for (uint32_t x = 0; x < img->comps[i].w; ++x)
                img->comps[i].data[y * img->comps[i].w + x] =
                    plane[(y * cp[i].dy) * w + x * cp[i].dx];
        free(plane);
    }
    fclose(f);
    void* codec = opj_create_compress(jp2 ? 2 : 0);
    if (!opj_setup_encoder(codec, &p, img)) return 5;
    const char* extra[3] = {0, 0, 0};
    int ne = 0;
    if (plt) extra[ne++] = "PLT=YES";
    if (tlm) extra[ne++] = "TLM=YES";
    if (ne && !opj_encoder_set_extra_options(codec, extra)) return 5;
    void* stream = opj_stream_create_default_file_stream(argv[2], 0);
    if (!stream) return 6;
    if (!opj_start_compress(codec, img, stream) || !opj_encode(codec, stream) ||
        !opj_end_compress(codec, stream))
        return 7;
    opj_stream_destroy(stream);
    opj_destroy_codec(codec);
    opj_image_destroy(img);
    return 0;
}
