// JPEG 2000 codestream decode as OpenJPEG 2.5.3 (the copy built into cv2
// 5.0) decodes a whole image with its default, strict settings: the main and
// tile-part headers (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, TLM, PLM,
// PLT, CRG, COM; SOT/SOD tile-parts and their length checks), tier 2 (the
// five progression orders and POC, tag trees, packet headers with SOP/EPH,
// packed headers), tier 1 (the MQ decoder, the three passes, every code-block
// style, ROI max-shift), dequantisation, the inverse 5/3 and 9/7 DWT, the
// inverse RCT and ICT, the DC level shift and the clamp. The result is one
// int32 plane per component; utils/jpeg2000.py does the JP2 container, the
// palette and channel definitions, and cv2's conversion to 8-bit BGR.
//
// The 9/7 path computes in float32 step by step as OpenJPEG's does; the file
// is built with -ffp-contract=off so that no multiply-add is fused.
//
// Status of j2k_decode: 0 decoded, 1 refused (what OpenJPEG or cv2's header
// checks refuse), 2 not ported (a feature OpenJPEG decodes and this port
// does not: its name in j2k_message).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Refused {
    int line;   // where in this file, for diagnostics
};
struct NotPorted {
    std::string what;
};

[[noreturn]] void refuse_at(int line) { throw Refused{line}; }
#define refuse() refuse_at(__LINE__)
[[noreturn]] void not_ported(const char* what) { throw NotPorted{what}; }

constexpr int MAXRLVLS = 33;
constexpr int MAXBANDS = 3 * MAXRLVLS - 2;

// markers
enum : uint32_t {
    M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9, M_CAP = 0xff50,
    M_SIZ = 0xff51, M_COD = 0xff52, M_COC = 0xff53, M_CPF = 0xff59, M_RGN = 0xff5e,
    M_QCD = 0xff5c, M_QCC = 0xff5d, M_POC = 0xff5f, M_TLM = 0xff55, M_PLM = 0xff57,
    M_PLT = 0xff58, M_PPM = 0xff60, M_PPT = 0xff61, M_SOP = 0xff91, M_CRG = 0xff63,
    M_COM = 0xff64, M_CBD = 0xff78, M_MCT = 0xff74, M_MCC = 0xff75, M_MCO = 0xff77,
    M_UNK = 0
};
// decoder states (j2k.c J2K_STATUS)
enum : uint32_t {
    S_MHSOC = 0x1, S_MHSIZ = 0x2, S_MH = 0x4, S_TPHSOT = 0x8, S_TPH = 0x10,
    S_NEOC = 0x40, S_DATA = 0x80, S_EOC = 0x100
};

struct Handler {
    uint32_t id, states;
};

// j2k_memory_marker_handler_tab: the states in which each marker may appear
Handler handler_of(uint32_t m) {
    switch (m) {
    case M_SOT: return {M_SOT, S_MH | S_TPHSOT};
    case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC: case M_COM:
    case M_MCT: case M_MCC: case M_MCO:
        return {m, S_MH | S_TPH};
    case M_SIZ: return {M_SIZ, S_MHSIZ};
    case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD: case M_CAP: case M_CPF:
        return {m, S_MH};
    case M_PLT: case M_PPT: return {m, S_TPH};
    case M_SOP: return {M_SOP, 0};
    default: return {M_UNK, S_MH | S_TPH};
    }
}

// OpenJPEG's stream over a memory buffer: reads return what is left
struct Stream {
    const uint8_t* d;
    int64_t n, pos = 0;
    int64_t left() const { return n - pos; }
    int64_t read(uint8_t* out, int64_t k) {
        int64_t r = std::min(k, left());
        if (r > 0) memcpy(out, d + pos, (size_t)r);
        pos += std::max<int64_t>(r, 0);
        return r;
    }
    uint32_t read_marker(bool& ok) {  // two bytes, big-endian
        uint8_t b[2];
        ok = read(b, 2) == 2;
        return ok ? (uint32_t)(b[0] << 8 | b[1]) : 0;
    }
    int64_t skip(int64_t k) {
        int64_t r = std::min(k, left());
        pos += r;
        return r;
    }
};

uint32_t rd(const uint8_t* p, int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = v << 8 | p[i];
    return v;
}

struct StepSize {
    int32_t expn = 0, mant = 0;
};

struct Tccp {
    uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    uint32_t qntsty = 0, numgbits = 0, roishift = 0;
    StepSize stepsizes[MAXBANDS];
    uint32_t prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0, prg = 0;
};

struct Ppx {
    bool present = false;
    std::vector<uint8_t> data;
};

struct Tcp {
    uint32_t csty = 0, numlayers = 0, mct = 0;
    int32_t prg = 0;   // -1: unknown
    std::vector<Tccp> tccps;
    bool poc = false;
    uint32_t numpocs = 0;
    Poc pocs[32];
    bool ppt = false, ppt_merged = false;
    std::vector<Ppx> ppt_markers;
    std::vector<uint8_t> ppt_buffer;
    size_t ppt_pos = 0;
    int32_t current_tile_part_number = -1;
    uint32_t nb_tile_parts = 0;
    bool has_data = false;            // OpenJPEG's m_data != NULL
    std::vector<uint8_t> data;
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 0, sgnd = 0;
    uint32_t x0 = 0, y0 = 0, w = 0, h = 0;
    std::vector<int32_t> data;
    bool decoded = false;
};

uint32_t ceildiv(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
int32_t int_ceildivpow2(int64_t a, uint32_t b) {
    return (int32_t)((a + ((int64_t)1 << b) - 1) >> b);
}
int32_t int_floordivpow2(int64_t a, uint32_t b) { return (int32_t)(a >> b); }

// ------------------------------------------------------ tile structures

struct TagTree {   // opj_tgt: a quad tree over the code-blocks of a precinct
    struct Node {
        int32_t parent, value, low;
    };
    std::vector<Node> nodes;
    void create(uint32_t w, uint32_t h) {
        nodes.clear();
        if ((uint64_t)w * h == 0) return;
        std::vector<uint32_t> lw{w}, lh{h}, start{0};
        uint64_t total = 0;
        for (;;) {
            uint64_t n = (uint64_t)lw.back() * lh.back();
            total += n;
            if (n <= 1) break;
            start.push_back((uint32_t)total);
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        nodes.resize((size_t)total);
        for (size_t l = 0; l < lw.size(); ++l)
            for (uint32_t j = 0; j < lh[l]; ++j)
                for (uint32_t i = 0; i < lw[l]; ++i) {
                    Node& nd = nodes[start[l] + j * lw[l] + i];
                    nd.parent = l + 1 < lw.size()
                                    ? (int32_t)(start[l + 1] + (j / 2) * lw[l + 1] + i / 2)
                                    : -1;
                }
        reset();
    }
    void reset() {
        for (Node& n : nodes) {
            n.value = 999;
            n.low = 0;
        }
    }
};

struct Seg {
    uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
    uint32_t numnewpasses = 0, newlen = 0;
};

struct Chunk {
    const uint8_t* data;
    uint32_t len;
};

struct Cblk {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};

struct Precinct {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    uint32_t bandno = 0;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int32_t numbps = 0;
    float stepsize = 0;
    std::vector<Precinct> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
    Band bands[3];
};

struct TileComp {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numres = 0;
    std::vector<Res> res;
    // the samples as OpenJPEG keeps them: int32 for the 5/3 path, the bits of
    // float32 for the 9/7 path (the colour transform reads them as component
    // 0's path says)
    std::vector<int32_t> data;
    float* f() { return reinterpret_cast<float*>(data.data()); }
};

// ------------------------------------------------------------------ decoder

struct Decoder {
    Stream s;
    uint32_t state = 0;
    // image (SIZ)
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, numcomps = 0;
    std::vector<Comp> comps;
    // coding parameters
    uint32_t tdx = 0, tdy = 0, tx0 = 0, ty0 = 0, tw = 0, th = 0;
    Tcp default_tcp;
    std::vector<std::unique_ptr<Tcp>> tcps;   // made from default_tcp when first used
    bool ppm = false;
    std::vector<Ppx> ppm_markers;
    std::vector<uint8_t> ppm_buffer;
    size_t ppm_pos = 0;
    // tile-part reading
    uint32_t current_tile = 0, sot_length = 0, nb_tile_parts_correction = 0;
    bool last_tile_part = false, can_decode = false, nb_tile_parts_correction_checked = false;
    // JP2's ihdr size (0 for a raw codestream)
    uint32_t ihdr_w = 0, ihdr_h = 0;

    Tcp& tile_tcp(uint32_t i) {
        if (!tcps[i]) {   // opj_j2k_copy_default_tcp_and_create_tcd
            tcps[i].reset(new Tcp(default_tcp));
            tcps[i]->ppt = false;
            tcps[i]->current_tile_part_number = -1;
        }
        return *tcps[i];
    }
    Tcp& tcp_for_marker() {
        return state == S_TPH ? tile_tcp(current_tile) : default_tcp;
    }

    void read_header();
    void read_marker_segment(uint32_t marker, const uint8_t* p, uint32_t size);
    void read_siz(const uint8_t* p, uint32_t size);
    void read_cod(const uint8_t* p, uint32_t size);
    void read_coc(const uint8_t* p, uint32_t size);
    void read_spcod(uint32_t compno, const uint8_t*& p, uint32_t& size);
    void read_sqcd(uint32_t compno, const uint8_t*& p, uint32_t& size);
    void read_qcd(const uint8_t* p, uint32_t size);
    void read_qcc(const uint8_t* p, uint32_t size);
    void read_rgn(const uint8_t* p, uint32_t size);
    void read_poc(const uint8_t* p, uint32_t size);
    void read_ppm(const uint8_t* p, uint32_t size);
    void read_ppt(const uint8_t* p, uint32_t size);
    void read_tlm(const uint8_t* p, uint32_t size);
    void read_plt(const uint8_t* p, uint32_t size);
    void read_sot(const uint8_t* p, uint32_t size);
    void merge_ppm();
    void merge_ppt(Tcp& tcp);
    void read_sod();
    bool need_nb_tile_parts_correction(uint32_t tile_no);
    bool read_tile_header(uint32_t& tile_no);
    void decode_tile(uint32_t tile_no, bool whole_image);
    void decode_tile_data(uint32_t tile_no, bool whole_image);
    void decode_all();
};

void Decoder::read_marker_segment(uint32_t marker, const uint8_t* p, uint32_t size) {
    switch (marker) {
    case M_SIZ: read_siz(p, size); break;
    case M_COD: read_cod(p, size); break;
    case M_COC: read_coc(p, size); break;
    case M_QCD: read_qcd(p, size); break;
    case M_QCC: read_qcc(p, size); break;
    case M_RGN: read_rgn(p, size); break;
    case M_POC: read_poc(p, size); break;
    case M_PPM: read_ppm(p, size); break;
    case M_PPT: read_ppt(p, size); break;
    case M_TLM: read_tlm(p, size); break;
    case M_PLM: if (size < 1) refuse(); break;
    case M_PLT: read_plt(p, size); break;
    case M_CRG: if (size != numcomps * 4) refuse(); break;
    case M_COM: break;
    case M_SOT: read_sot(p, size); break;
    case M_CAP: not_ported("HTJ2K (Part 15) capabilities marker (CAP)");
    case M_CPF: not_ported("corresponding-profile marker (CPF)");
    case M_MCT: case M_MCC: case M_MCO: case M_CBD:
        not_ported("Part 2 multiple component transform markers (MCT, MCC, MCO, CBD)");
    default: refuse();   // no handler ("Not sure how that happened")
    }
}

void Decoder::read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) refuse();
    uint32_t rem = size - 36;
    if (rem % 3) refuse();
    // Rsiz (p[0..1]), a Part 15 bit among its capabilities, changes nothing here
    x1 = rd(p + 2, 4); y1 = rd(p + 6, 4); x0 = rd(p + 10, 4); y0 = rd(p + 14, 4);
    tdx = rd(p + 18, 4); tdy = rd(p + 22, 4); tx0 = rd(p + 26, 4); ty0 = rd(p + 30, 4);
    uint32_t nc = rd(p + 34, 2);
    if (nc >= 16385) refuse();
    numcomps = nc;
    if (numcomps != rem / 3) refuse();
    if (x0 >= x1 || y0 >= y1) refuse();
    if (tdx == 0 || tdy == 0) refuse();
    uint32_t tx1 = (uint32_t)std::min<uint64_t>((uint64_t)tx0 + tdx, 0xffffffffu);
    uint32_t ty1 = (uint32_t)std::min<uint64_t>((uint64_t)ty0 + tdy, 0xffffffffu);
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) refuse();
    if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != x1 - x0 || ihdr_h != y1 - y0)) refuse();
    comps.assign(numcomps, Comp());
    const uint8_t* c = p + 36;
    for (uint32_t i = 0; i < numcomps; ++i, c += 3) {
        Comp& k = comps[i];
        k.prec = (c[0] & 0x7f) + 1;
        k.sgnd = c[0] >> 7;
        k.dx = c[1];
        k.dy = c[2];
        if (k.dx < 1 || k.dy < 1) refuse();
        if (k.prec > 31) refuse();
    }
    tw = ceildiv(x1 - tx0, tdx);
    th = ceildiv(y1 - ty0, tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th) refuse();
    default_tcp.tccps.assign(numcomps, Tccp());
    for (Comp& k : comps) {   // opj_image_comp_header_update
        k.x0 = ceildiv(x0, k.dx);
        k.y0 = ceildiv(y0, k.dy);
        k.w = ceildiv(x1, k.dx) - k.x0;
        k.h = ceildiv(y1, k.dy) - k.y0;
    }
    state = S_MH;
}

void Decoder::read_spcod(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    Tcp& tcp = tcp_for_marker();
    Tccp& t = tcp.tccps[compno];
    if (size < 5) refuse();
    t.numresolutions = p[0] + 1u;
    if (t.numresolutions > (uint32_t)MAXRLVLS) refuse();
    t.cblkw = p[1] + 2u;
    t.cblkh = p[2] + 2u;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) refuse();
    t.cblksty = p[3];
    if (t.cblksty & 0x80) refuse();   // mixed HT code-blocks: OpenJPEG refuses them
    t.qmfbid = p[4];
    if (t.qmfbid > 1) refuse();
    p += 5;
    size -= 5;
    if (t.csty & 1) {
        if (size < t.numresolutions) refuse();
        for (uint32_t i = 0; i < t.numresolutions; ++i) {
            uint32_t v = p[i];
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) refuse();
            t.prcw[i] = v & 0xf;
            t.prch[i] = v >> 4;
        }
        p += t.numresolutions;
        size -= t.numresolutions;
    } else {
        for (uint32_t i = 0; i < t.numresolutions; ++i) t.prcw[i] = t.prch[i] = 15;
    }
}

void Decoder::read_cod(const uint8_t* p, uint32_t size) {
    Tcp& tcp = tcp_for_marker();
    if (size < 5) refuse();
    tcp.csty = p[0];
    if (tcp.csty & ~7u) refuse();
    tcp.prg = p[1] > 4 ? -1 : p[1];
    tcp.numlayers = rd(p + 2, 2);
    if (tcp.numlayers < 1) refuse();
    tcp.mct = p[4];
    if (tcp.mct > 1) refuse();
    size -= 5;
    p += 5;
    for (uint32_t i = 0; i < numcomps; ++i) tcp.tccps[i].csty = tcp.csty & 1;
    read_spcod(0, p, size);
    if (size != 0) refuse();
    // opj_j2k_copy_tile_component_parameters
    const Tccp& r = tcp.tccps[0];
    for (uint32_t i = 1; i < numcomps; ++i) {
        Tccp& t = tcp.tccps[i];
        t.numresolutions = r.numresolutions;
        t.cblkw = r.cblkw;
        t.cblkh = r.cblkh;
        t.cblksty = r.cblksty;
        t.qmfbid = r.qmfbid;
        memcpy(t.prcw, r.prcw, sizeof t.prcw);
        memcpy(t.prch, r.prch, sizeof t.prch);
    }
}

void Decoder::read_coc(const uint8_t* p, uint32_t size) {
    Tcp& tcp = tcp_for_marker();
    uint32_t room = numcomps <= 256 ? 1 : 2;
    if (size < room + 1) refuse();
    size -= room + 1;
    uint32_t compno = rd(p, (int)room);
    p += room;
    if (compno >= numcomps) refuse();
    tcp.tccps[compno].csty = p[0];
    ++p;
    read_spcod(compno, p, size);
    if (size != 0) refuse();
}

void Decoder::read_sqcd(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    Tcp& tcp = tcp_for_marker();
    Tccp& t = tcp.tccps[compno];
    if (size < 1) refuse();
    size -= 1;
    uint32_t v = p[0];
    ++p;
    t.qntsty = v & 0x1f;
    t.numgbits = v >> 5;
    uint32_t nb;
    if (t.qntsty == 1) nb = 1;
    else nb = t.qntsty == 0 ? size : size / 2;
    if (t.qntsty == 0) {
        if (size < nb) refuse();
        for (uint32_t b = 0; b < nb; ++b) {
            if (b < (uint32_t)MAXBANDS) {
                t.stepsizes[b].expn = (int32_t)(p[b] >> 3);
                t.stepsizes[b].mant = 0;
            }
        }
        p += nb;
        size -= nb;
    } else {
        if (size < 2 * nb) refuse();
        for (uint32_t b = 0; b < nb; ++b) {
            uint32_t w = rd(p + 2 * b, 2);
            if (b < (uint32_t)MAXBANDS) {
                t.stepsizes[b].expn = (int32_t)(w >> 11);
                t.stepsizes[b].mant = (int32_t)(w & 0x7ff);
            }
        }
        p += 2 * nb;
        size -= 2 * nb;
    }
    if (t.qntsty == 1) {   // scalar derived: the other bands from the LL one
        for (int b = 1; b < MAXBANDS; ++b) {
            int32_t e = t.stepsizes[0].expn - (int32_t)((b - 1) / 3);
            t.stepsizes[b].expn = e > 0 ? e : 0;
            t.stepsizes[b].mant = t.stepsizes[0].mant;
        }
    }
}

void Decoder::read_qcd(const uint8_t* p, uint32_t size) {
    read_sqcd(0, p, size);
    if (size != 0) refuse();
    Tcp& tcp = tcp_for_marker();
    for (uint32_t i = 1; i < numcomps; ++i) {
        tcp.tccps[i].qntsty = tcp.tccps[0].qntsty;
        tcp.tccps[i].numgbits = tcp.tccps[0].numgbits;
        memcpy(tcp.tccps[i].stepsizes, tcp.tccps[0].stepsizes, sizeof tcp.tccps[0].stepsizes);
    }
}

void Decoder::read_qcc(const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps <= 256 ? 1 : 2;
    if (size < room) refuse();
    uint32_t compno = rd(p, (int)room);
    p += room;
    size -= room;
    if (compno >= numcomps) refuse();
    read_sqcd(compno, p, size);
    if (size != 0) refuse();
}

void Decoder::read_rgn(const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps <= 256 ? 1 : 2;
    if (size != 2 + room) refuse();
    Tcp& tcp = tcp_for_marker();
    uint32_t compno = rd(p, (int)room);
    if (compno >= numcomps) refuse();
    tcp.tccps[compno].roishift = p[room + 1];
}

void Decoder::read_poc(const uint8_t* p, uint32_t size) {
    uint32_t room = numcomps <= 256 ? 1 : 2;
    uint32_t chunk = 5 + 2 * room;
    uint32_t n = size / chunk;
    if (n == 0 || size % chunk) refuse();
    Tcp& tcp = tcp_for_marker();
    uint32_t old = tcp.poc ? tcp.numpocs + 1 : 0;
    uint32_t total = n + old;
    if (total >= 32) refuse();
    tcp.poc = true;
    for (uint32_t i = old; i < total; ++i) {
        Poc& c = tcp.pocs[i];
        c.resno0 = p[0];
        c.compno0 = rd(p + 1, (int)room);
        c.layno1 = std::min(rd(p + 1 + room, 2), tcp.numlayers);
        c.resno1 = p[3 + room];
        c.compno1 = std::min(rd(p + 4 + room, (int)room), numcomps);
        c.prg = p[4 + 2 * room];
        p += chunk;
    }
    tcp.numpocs = total - 1;
}

void Decoder::read_ppm(const uint8_t* p, uint32_t size) {
    if (size < 2) refuse();
    ppm = true;
    uint32_t z = p[0];
    if (ppm_markers.size() <= z) ppm_markers.resize(z + 1);
    if (ppm_markers[z].present) refuse();
    ppm_markers[z].present = true;
    ppm_markers[z].data.assign(p + 1, p + size);
}

void Decoder::merge_ppm() {
    if (!ppm) return;
    uint32_t remaining = 0;
    for (int pass = 0; pass < 2; ++pass) {
        remaining = 0;
        uint64_t total = 0;
        for (Ppx& m : ppm_markers) {
            if (!m.present) continue;
            const uint8_t* d = m.data.data();
            uint32_t n = (uint32_t)m.data.size();
            if (remaining >= n) {
                if (pass) ppm_buffer.insert(ppm_buffer.end(), d, d + n);
                remaining -= n;
                n = 0;
            } else {
                if (pass) ppm_buffer.insert(ppm_buffer.end(), d, d + remaining);
                d += remaining;
                n -= remaining;
                remaining = 0;
            }
            while (n > 0) {
                if (n < 4) refuse();   // not enough bytes to read Nppm
                uint32_t nppm = rd(d, 4);
                d += 4;
                n -= 4;
                total += nppm;
                if (total > 0xffffffffull) refuse();
                if (n >= nppm) {
                    if (pass) ppm_buffer.insert(ppm_buffer.end(), d, d + nppm);
                    n -= nppm;
                    d += nppm;
                } else {
                    if (pass) ppm_buffer.insert(ppm_buffer.end(), d, d + n);
                    remaining = nppm - n;
                    n = 0;
                }
            }
        }
        if (remaining != 0) refuse();   // corrupted PPM markers
    }
    ppm_markers.clear();
    ppm_pos = 0;
}

void Decoder::read_ppt(const uint8_t* p, uint32_t size) {
    if (size < 2) refuse();
    if (ppm) refuse();
    Tcp& tcp = tile_tcp(current_tile);
    tcp.ppt = true;
    uint32_t z = p[0];
    if (tcp.ppt_markers.size() <= z) tcp.ppt_markers.resize(z + 1);
    if (tcp.ppt_markers[z].present) refuse();
    tcp.ppt_markers[z].present = true;
    tcp.ppt_markers[z].data.assign(p + 1, p + size);
}

void Decoder::merge_ppt(Tcp& tcp) {
    if (tcp.ppt_merged) refuse();   // "opj_j2k_merge_ppt() has already been called"
    if (!tcp.ppt) return;
    tcp.ppt_merged = true;
    tcp.ppt_buffer.clear();
    for (Ppx& m : tcp.ppt_markers)
        if (m.present) tcp.ppt_buffer.insert(tcp.ppt_buffer.end(), m.data.begin(), m.data.end());
    tcp.ppt_markers.clear();
    tcp.ppt_pos = 0;
}

void Decoder::read_tlm(const uint8_t*, uint32_t size) {
    // OpenJPEG 2.5.3 keeps the tile-part lengths only to seek within one
    // tile; a malformed list marks them unusable and refuses nothing
    if (size < 2) refuse();
}

void Decoder::read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) refuse();
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; ++i) {
        len |= p[i] & 0x7f;
        if (p[i] & 0x80) len <<= 7;
        else len = 0;
    }
    if (len != 0) refuse();
}

void Decoder::read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) refuse();
    uint32_t tile_no = rd(p, 2), tot_len = rd(p + 2, 4), part = p[6], num_parts = p[7];
    current_tile = tile_no;
    if (tile_no >= tw * th) refuse();
    Tcp& tcp = tile_tcp(tile_no);
    if (tcp.current_tile_part_number + 1 != (int32_t)part) refuse();
    tcp.current_tile_part_number = (int32_t)part;
    if (tot_len != 0 && tot_len < 14 && tot_len != 12) refuse();
    if (!tot_len) last_tile_part = true;
    if (tcp.nb_tile_parts != 0 && part >= tcp.nb_tile_parts) {
        last_tile_part = true;
        refuse();
    }
    if (num_parts != 0) {
        num_parts += nb_tile_parts_correction;
        if (tcp.nb_tile_parts && part >= tcp.nb_tile_parts) refuse();
        if (part >= num_parts) refuse();
        tcp.nb_tile_parts = num_parts;
    }
    if (tcp.nb_tile_parts && tcp.nb_tile_parts == part + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : tot_len - 12;
    state = S_TPH;
}

// The main header (opj_j2k_read_header_procedure) up to the first SOT
void Decoder::read_header() {
    state = S_MHSOC;
    bool ok;
    uint32_t m = s.read_marker(ok);
    if (!ok || m != M_SOC) refuse();
    state = S_MHSIZ;
    m = s.read_marker(ok);
    if (!ok) refuse();
    bool has_siz = false, has_cod = false, has_qcd = false;
    std::vector<uint8_t> buf;
    while (m != M_SOT) {
        if (m < 0xff00) refuse();
        Handler h = handler_of(m);
        if (h.id == M_UNK) {   // opj_j2k_read_unk: two bytes at a time to a known marker
            for (;;) {
                uint32_t u = s.read_marker(ok);
                if (!ok) refuse();
                if (u >= 0xff00) {
                    Handler hu = handler_of(u);
                    if (!(state & hu.states)) refuse();
                    if (hu.id != M_UNK) {
                        h = hu;
                        break;
                    }
                }
            }
            m = h.id;
            if (m == M_SOT) break;
        }
        if (h.id == M_SIZ) has_siz = true;
        if (h.id == M_COD) has_cod = true;
        if (h.id == M_QCD) has_qcd = true;
        if (!(state & h.states)) refuse();
        uint32_t size = s.read_marker(ok);
        if (!ok || size < 2) refuse();
        size -= 2;
        buf.resize(size + 1);
        if (s.read(buf.data(), size) != size) refuse();
        read_marker_segment(h.id, buf.data(), size);
        m = s.read_marker(ok);
        if (!ok) refuse();
    }
    if (!has_siz || !has_cod || !has_qcd) refuse();
    merge_ppm();
    state = S_TPHSOT;
    tcps.clear();
    tcps.resize((size_t)tw * th);
}


// ------------------------------------------------------ tile-part reading

void Decoder::read_sod() {
    Tcp& tcp = tile_tcp(current_tile);
    if (last_tile_part) sot_length = (uint32_t)(s.left() - 2);
    else if (sot_length >= 2) sot_length -= 2;
    int64_t r = 0;
    if (sot_length) {
        if ((int64_t)sot_length > s.left()) refuse();   // strict: the tile-part is cut
        if (sot_length > 0xffffffffu - 2) refuse();
        tcp.has_data = true;
        size_t old = tcp.data.size();
        tcp.data.resize(old + sot_length);
        r = s.read(tcp.data.data() + old, sot_length);
        tcp.data.resize(old + (size_t)r);
    }
    state = r != (int64_t)sot_length ? S_NEOC : S_TPHSOT;
}

// opj_j2k_need_nb_tile_parts_correction: reads ahead over the tile-parts
// of other tiles to the next one of `tile_no`, and back
bool Decoder::need_nb_tile_parts_correction(uint32_t tile_no) {
    int64_t back = s.pos;
    bool need = false, ok;
    for (;;) {
        uint32_t m = s.read_marker(ok);
        if (!ok || m != M_SOT) break;
        uint32_t size = s.read_marker(ok);
        if (!ok) refuse();
        if (size != 10) refuse();
        uint8_t b[8];
        if (s.read(b, 8) != 8) refuse();
        uint32_t t = rd(b, 2), tot = rd(b + 2, 4), part = b[6], num = b[7];
        if (t == tile_no) {
            need = part == num;
            break;
        }
        if (tot < 14) break;
        if (s.skip(tot - 12) != (int64_t)(tot - 12)) break;
    }
    s.pos = back;
    return need;
}

bool Decoder::read_tile_header(uint32_t& tile_no) {
    const uint32_t ntiles = tw * th;
    uint32_t m = M_SOT;
    bool ok;
    if (state == S_EOC) m = M_EOC;
    else if (state != S_TPHSOT) refuse();
    std::vector<uint8_t> buf;
    while (!can_decode && m != M_EOC) {
        while (m != M_SOD) {
            if (s.left() == 0) {
                state = S_NEOC;
                break;
            }
            uint32_t size = s.read_marker(ok);
            if (!ok || size < 2) refuse();
            if (m == 0x8080 && s.left() == 0) {
                state = S_NEOC;
                break;
            }
            if ((state & S_TPH) && sot_length != 0) {
                if (sot_length < size + 2) refuse();
                sot_length -= size + 2;
            }
            size -= 2;
            Handler h = handler_of(m);
            if (!(state & h.states)) refuse();
            buf.resize(size + 1);
            if (s.read(buf.data(), size) != size) refuse();
            if (h.id == M_UNK) refuse();
            read_marker_segment(h.id, buf.data(), size);
            m = s.read_marker(ok);
            if (!ok) refuse();
        }
        if (s.left() == 0 && state == S_NEOC) break;
        read_sod();
        // OpenJPEG's look-ahead for writers that count one tile-part too few
        // (TPsot == TNsot in a later part of the tile): once, when the first
        // tile is complete, and (as cv2 5.0's build behaves) only when that
        // tile came in more than one part
        if (can_decode && !nb_tile_parts_correction_checked) {
            nb_tile_parts_correction_checked = true;
            if (tile_tcp(current_tile).current_tile_part_number > 0 &&
                need_nb_tile_parts_correction(current_tile)) {
                can_decode = false;
                nb_tile_parts_correction = 1;
                for (auto& t : tcps)
                    if (t && t->nb_tile_parts) t->nb_tile_parts += 1;
            }
        }
        if (!can_decode) {
            m = s.read_marker(ok);
            if (!ok) {
                // a last row of tiles with TPsot == TNsot == 0 and no EOC
                if (current_tile + 1 == ntiles) {
                    uint32_t t = 0;
                    for (; t < ntiles; ++t)
                        if (tcps[t] && tcps[t]->current_tile_part_number == 0 &&
                            tcps[t]->nb_tile_parts == 0)
                            break;
                    if (t < ntiles) {
                        current_tile = t;
                        m = M_EOC;
                        state = S_EOC;
                        break;
                    }
                }
                refuse();
            }
        }
    }
    if (m == M_EOC && state != S_EOC) {
        current_tile = 0;
        state = S_EOC;
    }
    if (!can_decode) {
        while (current_tile < ntiles && !(tcps[current_tile] && tcps[current_tile]->has_data))
            ++current_tile;
        if (current_tile == ntiles) return false;
    }
    merge_ppt(tile_tcp(current_tile));
    tile_no = current_tile;
    state |= S_DATA;
    return true;
}

void Decoder::decode_tile(uint32_t tile_no, bool whole_image) {
    Tcp& tcp = tile_tcp(tile_no);
    if (!tcp.has_data) refuse();
    decode_tile_data(tile_no, whole_image);
    can_decode = false;
    state &= ~S_DATA;
    if (s.left() == 0 && state == S_NEOC) return;
    if (state != S_EOC) {
        bool ok;
        uint32_t m = s.read_marker(ok);
        if (!ok) refuse();
        if (m == M_EOC) {
            current_tile = 0;
            state = S_EOC;
        } else if (m != M_SOT) {
            if (s.left() == 0) {
                state = S_NEOC;   // "Stream does not end with EOC"
                return;
            }
            refuse();
        }
    }
}

void Decoder::decode_all() {
    const uint32_t ntiles = tw * th;
    uint32_t t;
    if (tw == 1 && th == 1 && tx0 == 0 && ty0 == 0 && x0 == 0 && y0 == 0 && x1 == tdx &&
        y1 == tdy) {
        if (!read_tile_header(t)) refuse();
        decode_tile(t, true);
        return;
    }
    for (uint32_t nr = 0;;) {
        if (tw == 1 && th == 1 && tcps[0] && tcps[0]->has_data) {
            t = 0;
            current_tile = 0;
            state |= S_DATA;
        } else if (!read_tile_header(t)) {
            break;
        }
        decode_tile(t, false);
        Tcp& tcp = tile_tcp(t);
        std::vector<uint8_t>().swap(tcp.data);
        tcp.has_data = false;
        if (s.left() == 0 && state == S_NEOC) break;
        if (++nr == ntiles) break;
    }
    for (const Comp& c : comps)
        if (!c.decoded) refuse();   // "Failed to decode all used components"
}


// ------------------------------------------------------------- tier 2

struct Bio {   // opj_bio: the bit reader of packet headers
    const uint8_t *start, *bp, *end;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
    bool bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return false;
        buf |= *bp++;
        return true;
    }
    uint32_t getbit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n - 1; i < n; i--) v |= getbit() << i;
        return v;
    }
    bool inalign() {
        if ((buf & 0xff) == 0xff && !bytein()) return false;
        ct = 0;
        return true;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
    int32_t stk[32];
    int n = 0;
    int32_t node = (int32_t)leaf;
    while (tree.nodes[node].parent >= 0) {
        stk[n++] = node;
        node = tree.nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
        TagTree::Node& nd = tree.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.read(1)) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (n == 0) break;
        node = stk[--n];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

uint32_t getnumpasses(Bio& bio) {
    uint32_t n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
    if (index + 1 > cb.segs.size()) cb.segs.resize(index + 1);
    Seg& seg = cb.segs[index];
    seg = Seg();
    if (cblksty & 4) seg.maxpasses = 1;   // termall
    else if (cblksty & 1) {               // bypass
        if (first) seg.maxpasses = 10;
        else {
            uint32_t prev = cb.segs[index - 1].maxpasses;
            seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        seg.maxpasses = 109;
    }
}

struct PacketId {
    uint32_t compno, resno, precno, layno;
};

struct Tile {
    Decoder& dec;
    Tcp& tcp;
    std::vector<TileComp> comps;
    // per component, the highest resolution of a packet read (OpenJPEG's
    // resno_decoded): the inverse DWT, the level shift and the copy into the
    // image stop there
    std::vector<uint32_t> resno_decoded;
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    Tile(Decoder& d, Tcp& t) : dec(d), tcp(t) {}
    void init(uint32_t tile_no);
    void t2(const uint8_t* src, size_t len);
    bool next_packets(const Poc& poc, int32_t prg, std::vector<uint8_t>& include,
                      uint64_t steps[4], std::vector<PacketId>& out);
    void read_packet(const PacketId& pk, const uint8_t*& cur, size_t& left);
};

void Tile::init(uint32_t tile_no) {
    uint32_t p = tile_no % dec.tw, q = tile_no / dec.tw;
    uint64_t tx = (uint64_t)dec.tx0 + (uint64_t)p * dec.tdx;
    uint64_t ty = (uint64_t)dec.ty0 + (uint64_t)q * dec.tdy;
    x0 = (int32_t)(uint32_t)std::max<uint64_t>(tx, dec.x0);
    x1 = (int32_t)(uint32_t)std::min<uint64_t>(std::min<uint64_t>(tx + dec.tdx, 0xffffffffu),
                                               dec.x1);
    y0 = (int32_t)(uint32_t)std::max<uint64_t>(ty, dec.y0);
    y1 = (int32_t)(uint32_t)std::min<uint64_t>(std::min<uint64_t>(ty + dec.tdy, 0xffffffffu),
                                               dec.y1);
    if (x0 < 0 || x1 <= x0 || y0 < 0 || y1 <= y0) refuse();
    comps.assign(dec.numcomps, TileComp());
    resno_decoded.assign(dec.numcomps, 0);
    for (uint32_t c = 0; c < dec.numcomps; ++c) {
        const Comp& ic = dec.comps[c];
        const Tccp& tccp = tcp.tccps[c];
        if (tccp.cblksty & 0x40) not_ported("HTJ2K (Part 15) code-blocks");
        TileComp& tc = comps[c];
        tc.x0 = (int32_t)ceildiv((uint32_t)x0, ic.dx);
        tc.y0 = (int32_t)ceildiv((uint32_t)y0, ic.dy);
        tc.x1 = (int32_t)ceildiv((uint32_t)x1, ic.dx);
        tc.y1 = (int32_t)ceildiv((uint32_t)y1, ic.dy);
        tc.numres = tccp.numresolutions;
        tc.res.assign(tc.numres, Res());
        uint32_t band_index = 0;
        for (uint32_t r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            uint32_t level = tc.numres - 1 - r;
            res.x0 = int_ceildivpow2(tc.x0, level);
            res.y0 = int_ceildivpow2(tc.y0, level);
            res.x1 = int_ceildivpow2(tc.x1, level);
            res.y1 = int_ceildivpow2(tc.y1, level);
            uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
            res.pdx = pdx;
            res.pdy = pdy;
            int32_t tlx = int_floordivpow2(res.x0, pdx) << pdx;
            int32_t tly = int_floordivpow2(res.y0, pdy) << pdy;
            uint64_t brx = (uint64_t)(uint32_t)int_ceildivpow2(res.x1, pdx) << pdx;
            uint64_t bry = (uint64_t)(uint32_t)int_ceildivpow2(res.y1, pdy) << pdy;
            if ((uint32_t)brx > 0x7fffffffu || (uint32_t)bry > 0x7fffffffu) refuse();
            res.pw = res.x0 == res.x1 ? 0 : (uint32_t)(((int32_t)(uint32_t)brx - tlx) >> pdx);
            res.ph = res.y0 == res.y1 ? 0 : (uint32_t)(((int32_t)(uint32_t)bry - tly) >> pdy);
            if (res.pw != 0 && 0xffffffffu / res.pw < res.ph) refuse();
            uint64_t nprec = (uint64_t)res.pw * res.ph;
            if (nprec > 0xffffffffu / 56) refuse();
            int32_t cbgx, cbgy;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                cbgx = tlx;
                cbgy = tly;
                cbgw = pdx;
                cbgh = pdy;
                res.numbands = 1;
            } else {
                cbgx = int_ceildivpow2(tlx, 1);
                cbgy = int_ceildivpow2(tly, 1);
                cbgw = pdx - 1;
                cbgh = pdy - 1;
                res.numbands = 3;
            }
            uint32_t cblkw = std::min(tccp.cblkw, cbgw), cblkh = std::min(tccp.cblkh, cbgh);
            for (uint32_t b = 0; b < res.numbands; ++b, ++band_index) {
                Band& band = res.bands[b];
                if (r == 0) {
                    band.bandno = 0;
                    band.x0 = int_ceildivpow2(tc.x0, level);
                    band.y0 = int_ceildivpow2(tc.y0, level);
                    band.x1 = int_ceildivpow2(tc.x1, level);
                    band.y1 = int_ceildivpow2(tc.y1, level);
                } else {
                    band.bandno = b + 1;
                    int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
                    band.x0 = int_ceildivpow2(tc.x0 - (xb << level), level + 1);
                    band.y0 = int_ceildivpow2(tc.y0 - (yb << level), level + 1);
                    band.x1 = int_ceildivpow2(tc.x1 - (xb << level), level + 1);
                    band.y1 = int_ceildivpow2(tc.y1 - (yb << level), level + 1);
                }
                const StepSize& ss = tccp.stepsizes[band_index];
                int32_t log2_gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                                                        : band.bandno == 3 ? 2 : 1;
                int32_t rb = (int32_t)ic.prec + log2_gain;
                band.stepsize = (float)((1.0 + ss.mant / 2048.0) * pow(2.0, (double)(rb - ss.expn)));
                band.numbps = ss.expn + (int32_t)tccp.numgbits - 1;
                band.precs.assign((size_t)nprec, Precinct());
                for (uint32_t pn = 0; pn < nprec; ++pn) {
                    Precinct& pr = band.precs[pn];
                    int32_t px = cbgx + (int32_t)(pn % res.pw) * (1 << cbgw);
                    int32_t py = cbgy + (int32_t)(pn / res.pw) * (1 << cbgh);
                    pr.x0 = std::max(px, band.x0);
                    pr.y0 = std::max(py, band.y0);
                    pr.x1 = std::min(px + (1 << cbgw), band.x1);
                    pr.y1 = std::min(py + (1 << cbgh), band.y1);
                    int32_t bx0 = int_floordivpow2(pr.x0, cblkw) << cblkw;
                    int32_t by0 = int_floordivpow2(pr.y0, cblkh) << cblkh;
                    int32_t bx1 = int_ceildivpow2(pr.x1, cblkw) << cblkw;
                    int32_t by1 = int_ceildivpow2(pr.y1, cblkh) << cblkh;
                    pr.cw = (uint32_t)((bx1 - bx0) >> cblkw);
                    pr.ch = (uint32_t)((by1 - by0) >> cblkh);
                    uint64_t ncb = (uint64_t)pr.cw * pr.ch;
                    if (ncb > (1u << 26)) refuse();
                    pr.cblks.assign((size_t)ncb, Cblk());
                    for (uint32_t k = 0; k < ncb; ++k) {
                        Cblk& cb = pr.cblks[k];
                        int32_t cx = bx0 + (int32_t)(k % pr.cw) * (1 << cblkw);
                        int32_t cy = by0 + (int32_t)(k / pr.cw) * (1 << cblkh);
                        cb.x0 = std::max(cx, pr.x0);
                        cb.y0 = std::max(cy, pr.y0);
                        cb.x1 = std::min(cx + (1 << cblkw), pr.x1);
                        cb.y1 = std::min(cy + (1 << cblkh), pr.y1);
                    }
                    pr.incl.create(pr.cw, pr.ch);
                    pr.imsb.create(pr.cw, pr.ch);
                }
            }
        }
    }
}

// The packets of one progression (opj_pi_next_*), in order; false where
// OpenJPEG's iterator stops early.
bool Tile::next_packets(const Poc& poc, int32_t prg, std::vector<uint8_t>& include,
                        uint64_t steps[4], std::vector<PacketId>& out) {
    const uint32_t numcomps = dec.numcomps;
    if (poc.compno0 >= numcomps || poc.compno1 >= numcomps + 1) return false;
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t pn) -> int {
        uint64_t index = l * steps[0] + r * steps[1] + c * steps[2] + pn * steps[3];
        if (index >= include.size()) return -1;
        if (!include[index]) {
            include[index] = 1;
            out.push_back({c, r, pn, l});
        }
        return 0;
    };
    auto pw_ph = [&](uint32_t c, uint32_t r) { return (uint64_t)comps[c].res[r].pw * comps[c].res[r].ph; };
    if (prg == 0 || prg == 1) {   // LRCP, RLCP
        auto lrc = [&](uint32_t l, uint32_t r) -> bool {
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (r >= comps[c].numres) continue;
                uint64_t np = pw_ph(c, r);
                for (uint64_t pn = 0; pn < np; ++pn)
                    if (emit(l, r, c, (uint32_t)pn) < 0) return false;
            }
            return true;
        };
        if (prg == 0) {
            for (uint32_t l = 0; l < poc.layno1; ++l)
                for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
                    if (!lrc(l, r)) return false;
        } else {
            for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
                for (uint32_t l = 0; l < poc.layno1; ++l)
                    if (!lrc(l, r)) return false;
        }
        return true;
    }
    if (prg < 2 || prg > 4) return false;
    // RPCL, PCRL, CPRL: positions on the grid of the precincts
    auto dxdy = [&](uint32_t c0, uint32_t c1, uint32_t& dx, uint32_t& dy) {
        dx = dy = 0;
        for (uint32_t c = c0; c < c1; ++c) {
            const Comp& ic = dec.comps[c];
            const TileComp& tc = comps[c];
            for (uint32_t r = 0; r < tc.numres; ++r) {
                uint32_t e = tc.res[r].pdx + tc.numres - 1 - r;
                if (e < 32 && ic.dx <= 0xffffffffu / (1u << e)) {
                    uint32_t v = ic.dx * (1u << e);
                    dx = !dx ? v : std::min(dx, v);
                }
                e = tc.res[r].pdy + tc.numres - 1 - r;
                if (e < 32 && ic.dy <= 0xffffffffu / (1u << e)) {
                    uint32_t v = ic.dy * (1u << e);
                    dy = !dy ? v : std::min(dy, v);
                }
            }
        }
        return dx != 0 && dy != 0;
    };
    const uint32_t tx0 = (uint32_t)x0, ty0 = (uint32_t)y0, tx1 = (uint32_t)x1, ty1 = (uint32_t)y1;
    // one (resolution, x, y, component) visit: its precinct's layers
    auto visit = [&](uint32_t r, uint32_t x, uint32_t y, uint32_t c) -> int {
        const Comp& ic = dec.comps[c];
        const TileComp& tc = comps[c];
        if (r >= tc.numres) return 0;
        const Res& res = tc.res[r];
        uint32_t level = tc.numres - 1 - r;
        if ((uint32_t)(((uint64_t)ic.dx << level) >> level) != ic.dx ||
            (uint32_t)(((uint64_t)ic.dy << level) >> level) != ic.dy)
            return 0;
        uint64_t dxl = (uint64_t)ic.dx << level, dyl = (uint64_t)ic.dy << level;
        uint32_t trx0 = (uint32_t)((tx0 + dxl - 1) / dxl), try0 = (uint32_t)((ty0 + dyl - 1) / dyl);
        uint32_t trx1 = (uint32_t)((tx1 + dxl - 1) / dxl), try1 = (uint32_t)((ty1 + dyl - 1) / dyl);
        uint32_t rpx = res.pdx + level, rpy = res.pdy + level;
        if (rpx >= 31 || ((ic.dx << rpx) >> rpx) != ic.dx || rpy >= 31 ||
            ((ic.dy << rpy) >> rpy) != ic.dy)
            return 0;
        if (!((uint64_t)y % ((uint64_t)ic.dy << rpy) == 0 ||
              (y == ty0 && (((uint64_t)try0 << level) % ((uint64_t)1 << rpy)))))
            return 0;
        if (!((uint64_t)x % ((uint64_t)ic.dx << rpx) == 0 ||
              (x == tx0 && (((uint64_t)trx0 << level) % ((uint64_t)1 << rpx)))))
            return 0;
        if (res.pw == 0 || res.ph == 0) return 0;
        if (trx0 == trx1 || try0 == try1) return 0;
        uint32_t prci = (uint32_t)(((x + dxl - 1) / dxl) >> res.pdx) - (trx0 >> res.pdx);
        uint32_t prcj = (uint32_t)(((y + dyl - 1) / dyl) >> res.pdy) - (try0 >> res.pdy);
        uint32_t pn = prci + prcj * res.pw;
        for (uint32_t l = 0; l < poc.layno1; ++l)
            if (emit(l, r, c, pn) < 0) return -1;
        return 0;
    };
    uint32_t dx, dy;
    if (prg == 2) {   // RPCL
        if (!dxdy(0, numcomps, dx, dy)) return false;
        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
            for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t c = poc.compno0; c < poc.compno1; ++c)
                        if (visit(r, x, y, c) < 0) return false;
    } else if (prg == 3) {   // PCRL
        if (!dxdy(0, numcomps, dx, dy)) return false;
        for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                for (uint32_t c = poc.compno0; c < poc.compno1; ++c)
                    for (uint32_t r = poc.resno0; r < std::min(poc.resno1, comps[c].numres); ++r)
                        if (visit(r, x, y, c) < 0) return false;
    } else {   // CPRL
        for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
            if (!dxdy(c, c + 1, dx, dy)) return false;
            for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t r = poc.resno0; r < std::min(poc.resno1, comps[c].numres); ++r)
                        if (visit(r, x, y, c) < 0) return false;
        }
    }
    return true;
}


void Tile::read_packet(const PacketId& pk, const uint8_t*& cur, size_t& left) {
    TileComp& tc = comps[pk.compno];
    Res& res = tc.res[pk.resno];
    const Tccp& tccp = tcp.tccps[pk.compno];
    if (pk.layno == 0) {   // reset the tag trees and the code-blocks' segments
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            if (pk.precno >= band.precs.size()) refuse();
            Precinct& pr = band.precs[pk.precno];
            pr.incl.reset();
            pr.imsb.reset();
            for (Cblk& cb : pr.cblks) cb.numsegs = cb.real_num_segs = 0;
        }
    }
    const uint8_t* src = cur;
    const size_t max_length = left;
    const uint8_t* data = cur;
    if (tcp.csty & 2) {   // SOP: optional, skipped when present
        if (max_length >= 6 && data[0] == 0xff && data[1] == 0x91) data += 6;
    }
    // the header's bytes: packed in PPM or PPT, else in the tile data
    const uint8_t* hstart;
    size_t hlen;
    if (dec.ppm) {
        hstart = dec.ppm_buffer.data() + dec.ppm_pos;
        hlen = dec.ppm_buffer.size() - dec.ppm_pos;
    } else if (tcp.ppt) {
        hstart = tcp.ppt_buffer.data() + tcp.ppt_pos;
        hlen = tcp.ppt_buffer.size() - tcp.ppt_pos;
    } else {
        hstart = data;
        hlen = (size_t)(src + max_length - data);
    }
    Bio bio(hstart, hlen);
    bool present = bio.read(1) != 0;
    const uint8_t* hd = hstart;
    if (present) {
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precs[pk.precno];
            for (uint32_t k = 0; k < pr.cblks.size(); ++k) {
                Cblk& cb = pr.cblks[k];
                uint32_t included = !cb.numsegs ? tgt_decode(bio, pr.incl, k, (int32_t)pk.layno + 1)
                                                : bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    uint32_t i = 0;
                    while (!tgt_decode(bio, pr.imsb, k, (int32_t)i)) ++i;
                    cb.numbps = (uint32_t)band.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                uint32_t increment = 0;
                while (bio.read(1)) ++increment;
                cb.numlenbits += increment;
                uint32_t segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, 0, tccp.cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                }
                int32_t n = (int32_t)cb.numnewpasses;
                do {
                    Seg& sg = cb.segs[segno];
                    sg.numnewpasses = (uint32_t)std::min<int32_t>(
                        (int32_t)(sg.maxpasses - sg.numpasses), n);
                    uint32_t nbits = cb.numlenbits;
                    for (uint32_t v = sg.numnewpasses; v > 1; v >>= 1) ++nbits;   // floorlog2
                    if (nbits > 32) refuse();
                    sg.newlen = bio.read(nbits);
                    n -= (int32_t)sg.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, tccp.cblksty, false);
                    }
                } while (n > 0);
            }
        }
        if (!bio.inalign()) refuse();
    } else {
        bio.inalign();
    }
    hd += bio.numbytes();
    if (tcp.csty & 4) {   // EPH: required after every header (SOP stays optional)
        size_t used = (size_t)(hd - hstart);
        if (hlen - used < 2 || hd[0] != 0xff || hd[1] != 0x92) refuse();
        hd += 2;
    }
    size_t hlength = (size_t)(hd - hstart);
    if (dec.ppm) dec.ppm_pos += hlength;
    else if (tcp.ppt) tcp.ppt_pos += hlength;
    else data += hlength;
    size_t read = (size_t)(data - src);
    cur += read;
    left -= read;
    if (!present) return;
    // the packet's body (opj_t2_read_packet_data); strict: a segment past the end refuses
    const uint8_t* body = cur;
    for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Precinct& pr = band.precs[pk.precno];
        for (Cblk& cb : pr.cblks) {
            if (!cb.numnewpasses) continue;
            Seg* sg;
            if (!cb.numsegs) {
                sg = &cb.segs[0];
                ++cb.numsegs;
            } else {
                sg = &cb.segs[cb.numsegs - 1];
                if (sg->numpasses == sg->maxpasses) {
                    ++sg;
                    ++cb.numsegs;
                }
            }
            do {
                if ((uint64_t)(body - cur) + sg->newlen > left) refuse();
                cb.chunks.push_back({body, sg->newlen});
                body += sg->newlen;
                sg->len += sg->newlen;
                sg->numpasses += sg->numnewpasses;
                cb.numnewpasses -= sg->numnewpasses;
                sg->real_num_passes = sg->numpasses;
                if (cb.numnewpasses > 0) {
                    ++sg;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
            cb.real_num_segs = cb.numsegs;
        }
    }
    size_t used = (size_t)(body - cur);
    cur += used;
    left -= used;
}

void Tile::t2(const uint8_t* src, size_t len) {
    // opj_pi_create_decode: the steps of the include array
    uint64_t max_prec = 0, max_res = 0;
    for (const TileComp& tc : comps) {
        max_res = std::max<uint64_t>(max_res, tc.numres);
        for (const Res& r : tc.res)
            max_prec = std::max<uint64_t>(max_prec, (uint64_t)(uint32_t)(r.pw * r.ph));
    }
    uint64_t steps[4];
    steps[3] = 1;
    steps[2] = max_prec;
    steps[1] = dec.numcomps * steps[2];
    steps[0] = max_res * steps[1];
    if (steps[0] > 0xffffffffull || steps[0] > 0xffffffffull / (tcp.numlayers + 1ull)) refuse();
    uint64_t include_size = (tcp.numlayers + 1ull) * steps[0];
    if (include_size > (1ull << 31)) refuse();
    std::vector<uint8_t> include((size_t)include_size, 0);
    std::vector<Poc> pocs;
    std::vector<int32_t> prgs;
    if (tcp.poc) {
        for (uint32_t i = 0; i <= tcp.numpocs; ++i) {
            Poc p = tcp.pocs[i];
            p.layno1 = std::min(p.layno1, tcp.numlayers);
            pocs.push_back(p);
            prgs.push_back((int32_t)p.prg);
        }
    } else {
        Poc p;
        p.resno0 = 0;
        p.compno0 = 0;
        p.resno1 = (uint32_t)max_res;
        p.compno1 = dec.numcomps;
        p.layno1 = tcp.numlayers;
        pocs.push_back(p);
        prgs.push_back(tcp.prg);
    }
    const uint8_t* cur = src;
    size_t left = len;
    std::vector<PacketId> packets;
    for (size_t i = 0; i < pocs.size(); ++i) {
        if (prgs[i] == -1) refuse();
        packets.clear();
        next_packets(pocs[i], prgs[i], include, steps, packets);
        for (const PacketId& pk : packets) {
            read_packet(pk, cur, left);
            resno_decoded[pk.compno] = std::max(resno_decoded[pk.compno], pk.resno);
        }
    }
}


// ------------------------------------------------------------- tier 1

struct MqState {
    uint16_t qeval;
    uint8_t mps, nmps, nlps;
};

// the 47 states of the MQ coder, each for MPS 0 and MPS 1 (mqc.c mqc_states)
const uint16_t QE[47] = {0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401,
                         0x4801, 0x3801, 0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401,
                         0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
                         0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0ac1, 0x09c1,
                         0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
                         0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                          17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                          33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                          15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                          30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct Mqc {   // mqc.c / mqc_inl.h, the decoder
    const uint8_t* bp;   // the segment, followed by 0xff 0xff
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[NUM_CTX], mps[NUM_CTX];

    void setstate(int ctx, uint8_t m, uint8_t st) {
        state[ctx] = st;
        mps[ctx] = m;
    }
    void reset_states() {
        for (int i = 0; i < NUM_CTX; ++i) setstate(i, 0, 0);
        setstate(CTX_UNI, 0, 46);
        setstate(CTX_AGG, 0, 3);
        setstate(CTX_ZC, 0, 4);
    }
    void bytein() {
        uint32_t next = bp[1];
        if (bp[0] == 0xff) {
            if (next > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += next << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += next << 8;
            ct = 8;
        }
    }
    void init_dec(const uint8_t* p, uint32_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : (uint32_t)*bp << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void raw_init_dec(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    void renormd() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    uint32_t decode(int ctx) {
        uint32_t d;
        uint8_t st = state[ctx];
        uint32_t q = QE[st];
        a -= q;
        if ((c >> 16) < q) {   // LPS exchange
            if (a < q) {
                d = mps[ctx];
                state[ctx] = NMPS[st];
            } else {
                d = !mps[ctx];
                if (SWITCH[st]) mps[ctx] = !mps[ctx];
                state[ctx] = NLPS[st];
            }
            a = q;
            renormd();
        } else {
            c -= q << 16;
            if ((a & 0x8000) == 0) {   // MPS exchange
                if (a < q) {
                    d = !mps[ctx];
                    if (SWITCH[st]) mps[ctx] = !mps[ctx];
                    state[ctx] = NLPS[st];
                } else {
                    d = mps[ctx];
                    state[ctx] = NMPS[st];
                }
                renormd();
            } else {
                d = mps[ctx];
            }
        }
        return d;
    }
    uint32_t raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp;
                    ++bp;
                    ct = 7;
                }
            } else {
                c = *bp;
                ++bp;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

// One code-block's coefficients (t1.c opj_t1_decode_cblk), at twice their
// scale with the reconstruction's half bit, as OpenJPEG keeps them.
struct T1 {
    enum : uint8_t { SIG = 1, NEG = 2, PI = 4, MU = 8 };
    // which neighbours of a sample are significant, as that sample sees them
    enum : uint8_t { NW_ = 1, N_ = 2, NE_ = 4, W_ = 8, E_ = 16, SW_ = 32, S_ = 64, SE_ = 128 };
    uint32_t w = 0, h = 0, stride = 0;
    std::vector<int32_t> data;
    std::vector<uint8_t> f, nb;   // (w + 2) x (h + 2), a border of insignificant samples
    Mqc mqc;
    bool vsc = false;
    const uint8_t* zc_lut = nullptr;

    size_t at(uint32_t x, uint32_t y) const { return (size_t)(y + 1) * stride + x + 1; }

    // the zero-coding contexts of t1_init_ctxno_zc, by band and neighbour bits
    struct ZcLuts {
        uint8_t lut[4][256];
        ZcLuts() {
            for (int o = 0; o < 4; ++o)
                for (int m = 0; m < 256; ++m) {
                    int hh = !!(m & W_) + !!(m & E_), vv = !!(m & N_) + !!(m & S_);
                    int dd = !!(m & NW_) + !!(m & NE_) + !!(m & SW_) + !!(m & SE_);
                    int n;
                    if (o == 3) {
                        int hv = hh + vv;
                        if (!dd) n = !hv ? 0 : hv == 1 ? 1 : 2;
                        else if (dd == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
                        else if (dd == 2) n = !hv ? 6 : 7;
                        else n = 8;
                    } else {
                        if (o == 1) std::swap(hh, vv);
                        if (!hh) n = !vv ? (!dd ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
                        else if (hh == 1) n = !vv ? (!dd ? 5 : 6) : 7;
                        else n = 8;
                    }
                    lut[o][m] = (uint8_t)(CTX_ZC + n);
                }
        }
    };
    static const uint8_t* zc_table(uint32_t orient) {
        static const ZcLuts luts;   // built once, thread-safely
        return luts.lut[orient];
    }
    int zc_ctx(size_t i) const { return zc_lut[nb[i]]; }
    // sign context and the bit it is xored with
    int sc_ctx(size_t i, uint32_t& spb) const {
        const uint8_t m = nb[i];
        auto sign = [&](uint8_t bit, size_t j) {
            return !(m & bit) ? 0 : (f[j] & NEG) ? -1 : 1;
        };
        // a positive and a negative neighbour cancel: min(pos, 1) - min(neg, 1)
        auto sum = [](int a, int b) {
            int pos = (a == 1) + (b == 1), neg = (a == -1) + (b == -1);
            return std::min(pos, 1) - std::min(neg, 1);
        };
        int hc = sum(sign(W_, i - 1), sign(E_, i + 1));
        int vc = sum(sign(N_, i - stride), sign(S_, i + stride));
        spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
        if (hc < 0) {
            hc = -hc;
            vc = -vc;
        }
        int n;
        if (!hc) n = vc == 0 ? 0 : 1;
        else n = vc == -1 ? 2 : !vc ? 3 : 4;
        return CTX_SC + n;
    }
    // a sample turns significant: its neighbours learn it, except that with
    // the vertically causal style a stripe's last row does not see the row
    // below it (OpenJPEG's opj_t1_update_flags)
    void set_sig(uint32_t x, uint32_t y, uint32_t neg, int32_t oneplushalf) {
        const size_t i = at(x, y);
        data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
        f[i] |= SIG | (neg ? NEG : 0);
        nb[i - 1] |= E_;
        nb[i + 1] |= W_;
        if (!(vsc && (y & 3) == 0)) {
            nb[i - stride] |= S_;
            nb[i - stride - 1] |= SE_;
            nb[i - stride + 1] |= SW_;
        }
        nb[i + stride] |= N_;
        nb[i + stride - 1] |= NE_;
        nb[i + stride + 1] |= NW_;
    }

    template <typename Fn>
    void scan(Fn fn) {   // stripes of four rows, column by column
        for (uint32_t k = 0; k < h; k += 4)
            for (uint32_t x = 0; x < w; ++x)
                for (uint32_t y = k; y < std::min(k + 4, h); ++y) fn(x, y);
    }

    void sigpass(int32_t bpno, bool raw) {
        int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
        scan([&](uint32_t x, uint32_t y) {
            const size_t i = at(x, y);
            if ((f[i] & (SIG | PI)) || !nb[i]) return;
            if (raw) {
                if (mqc.raw_decode()) set_sig(x, y, mqc.raw_decode(), oph);
            } else if (mqc.decode(zc_ctx(i))) {
                uint32_t spb;
                int ctx = sc_ctx(i, spb);
                set_sig(x, y, mqc.decode(ctx) ^ spb, oph);
            }
            f[i] |= PI;
        });
    }
    void refpass(int32_t bpno, bool raw) {
        int32_t poshalf = (1 << bpno) >> 1;
        scan([&](uint32_t x, uint32_t y) {
            const size_t i = at(x, y);
            if ((f[i] & (SIG | PI)) != SIG) return;
            uint32_t v;
            if (raw) {
                v = mqc.raw_decode();
            } else {
                int ctx = (f[i] & MU) ? CTX_MAG + 2 : nb[i] ? CTX_MAG + 1 : CTX_MAG;
                v = mqc.decode(ctx);
            }
            int32_t& d = data[(size_t)y * w + x];
            d += (v ^ (d < 0)) ? poshalf : -poshalf;
            f[i] |= MU;
        });
    }
    void clnpass(int32_t bpno, uint32_t cblksty) {
        int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
        auto step = [&](uint32_t x, uint32_t y, bool partial) {
            const size_t i = at(x, y);
            if (!partial && !mqc.decode(zc_ctx(i))) return;
            uint32_t spb;
            int ctx = sc_ctx(i, spb);
            set_sig(x, y, mqc.decode(ctx) ^ spb, oph);
        };
        for (uint32_t k = 0; k < h; k += 4) {
            for (uint32_t x = 0; x < w; ++x) {
                if (k + 4 <= h) {
                    // a run of four: the column and its neighbours all insignificant and unvisited
                    bool quiet = true;
                    for (uint32_t y = k; y < k + 4 && quiet; ++y) {
                        const size_t i = at(x, y);
                        if (f[i] || nb[i]) quiet = false;
                    }
                    if (quiet) {
                        if (!mqc.decode(CTX_AGG)) continue;
                        uint32_t run = mqc.decode(CTX_UNI);
                        run = run << 1 | mqc.decode(CTX_UNI);
                        step(x, k + run, true);
                        for (uint32_t y = k + run + 1; y < k + 4; ++y) step(x, y, false);
                        continue;
                    }
                }
                for (uint32_t y = k; y < std::min(k + 4, h); ++y) {
                    if (f[at(x, y)] & (SIG | PI)) continue;
                    step(x, y, false);
                }
            }
        }
        for (uint8_t& v : f) v &= (uint8_t)~PI;
        if (cblksty & 32) {   // segmentation symbol: four bits, not checked
            for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
        }
    }

    // false where OpenJPEG fails the tile (a bit-plane count past 30)
    bool decode(const Cblk& cb, uint32_t band_orient, uint32_t roishift, uint32_t cblksty) {
        w = (uint32_t)(cb.x1 - cb.x0);
        h = (uint32_t)(cb.y1 - cb.y0);
        stride = w + 2;
        data.assign((size_t)w * h, 0);
        f.assign((size_t)stride * (h + 2), 0);
        nb.assign((size_t)stride * (h + 2), 0);
        zc_lut = zc_table(band_orient);
        vsc = (cblksty & 8) != 0;
        int32_t bpno_plus_one = (int32_t)(roishift + cb.numbps);
        if (bpno_plus_one >= 31) return false;
        mqc.reset_states();
        if (cb.chunks.empty()) return true;
        std::vector<uint8_t> buf;
        for (const Chunk& ch : cb.chunks) buf.insert(buf.end(), ch.data, ch.data + ch.len);
        size_t total = buf.size();
        buf.resize(total + 2);
        uint32_t passtype = 2;
        size_t index = 0;
        std::vector<uint8_t> seg;
        for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
            const Seg& sg = cb.segs[segno];
            bool raw = bpno_plus_one <= (int32_t)cb.numbps - 4 && passtype < 2 && (cblksty & 1);
            // the segment with the two 0xff bytes OpenJPEG puts after it
            size_t end = std::min(total, index + sg.len);
            seg.assign(buf.begin() + (ptrdiff_t)std::min(index, total), buf.begin() + (ptrdiff_t)end);
            seg.push_back(0xff);
            seg.push_back(0xff);
            if (raw) mqc.raw_init_dec(seg.data());
            else mqc.init_dec(seg.data(), sg.len);
            index += sg.len;
            for (uint32_t pass = 0; pass < sg.real_num_passes && bpno_plus_one >= 1; ++pass) {
                // OpenJPEG's passes take bpno_plus_one as their bit-plane: the
                // coefficients carry one more bit, the half of the last plane
                if (passtype == 0) sigpass(bpno_plus_one, raw);
                else if (passtype == 1) refpass(bpno_plus_one, raw);
                else clnpass(bpno_plus_one, cblksty);
                if ((cblksty & 2) && !raw) mqc.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    bpno_plus_one--;
                }
            }
        }
        return true;
    }
};


// ------------------------------------------------- inverse wavelet transforms

inline int32_t add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

// One line of the inverse 5/3 (dwt.c opj_idwt53_h / opj_idwt53_v): `in` holds
// sn low then dn high samples, `out` gets them interleaved. 32-bit wrapping
// arithmetic, as OpenJPEG's (SIMD) lanes compute.
void idwt53_line(const int32_t* in, int32_t* out, int32_t sn, int32_t len, int32_t cas) {
    if (len <= 0) return;
    if (cas == 0) {
        if (len <= 1) {
            if (len == 1) out[0] = in[0];
            return;
        }
        const int32_t* ev = in;       // low
        const int32_t* od = in + sn;  // high
        int32_t s1n = ev[0], d1n = od[0];
        int32_t s0n = sub(s1n, add(d1n, 1) >> 1);
        int32_t i = 0, j = 1;
        for (; i < len - 3; i += 2, j++) {
            int32_t d1c = d1n, s0c = s0n;
            s1n = ev[j];
            d1n = od[j];
            s0n = sub(s1n, add(add(d1c, d1n), 2) >> 2);
            out[i] = s0c;
            out[i + 1] = add(d1c, add(s0c, s0n) >> 1);
        }
        out[i] = s0n;
        if (len & 1) {
            out[len - 1] = sub(ev[(len - 1) / 2], add(d1n, 1) >> 1);
            out[len - 2] = add(d1n, add(s0n, out[len - 1]) >> 1);
        } else {
            out[len - 1] = add(d1n, s0n);
        }
        return;
    }
    if (len == 1) {
        out[0] = in[0] / 2;
        return;
    }
    const int32_t* ev = in + sn;  // high, at even positions
    const int32_t* od = in;       // low, at odd positions
    if (len == 2) {
        out[1] = sub(od[0], add(ev[0], 1) >> 1);
        out[0] = add(ev[0], out[1]);
        return;
    }
    int32_t s1 = ev[1];
    int32_t dc = sub(od[0], add(add(ev[0], s1), 2) >> 2);
    out[0] = add(ev[0], dc);
    int32_t i = 1, j = 1;
    for (; i < len - 2 - !(len & 1); i += 2, j++) {
        int32_t s2 = ev[j + 1];
        int32_t dn = sub(od[j], add(add(s1, s2), 2) >> 2);
        out[i] = dc;
        out[i + 1] = add(s1, add(dn, dc) >> 1);
        dc = dn;
        s1 = s2;
    }
    out[i] = dc;
    if (!(len & 1)) {
        int32_t dn = sub(od[len / 2 - 1], add(s1, 1) >> 1);
        out[len - 2] = add(s1, add(dn, dc) >> 1);
        out[len - 1] = dn;
    } else {
        out[len - 1] = add(s1, dc);
    }
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f, DWT_GAMMA = 0.882911075f,
            DWT_DELTA = 0.443506852f, DWT_K = 1.230174105f,
            DWT_TWO_INVK = 1.625732422f;   // OpenJPEG's historic 2 / K

// opj_v8dwt_decode_step2 on one lane: w[a + 2i] += (left + right) * c
void lift97(float* x, int32_t lo, int32_t hi, uint32_t end, uint32_t m, float c) {
    // `lo`: index of the first sample lifted; `hi`: index of its first left neighbour
    uint32_t imax = std::min(end, m);
    float left = x[hi];
    uint32_t i = 0;
    for (; i < imax; ++i) {
        float& w = x[lo + 2 * i];
        float right = x[lo + 2 * i + 1];
        w = w + (left + right) * c;
        left = right;
    }
    if (m < end) {
        float cc = c + c;
        float& w = x[lo + 2 * i];
        w = w + left * cc;
    }
}

// One line of the inverse 9/7 (opj_v8dwt_decode), already interleaved
void idwt97_line(float* x, int32_t sn, int32_t dn, int32_t cas) {
    int32_t a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0;
        b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1;
        b = 0;
    }
    for (int32_t i = 0; i < sn; ++i) x[a + 2 * i] = x[a + 2 * i] * DWT_K;
    for (int32_t i = 0; i < dn; ++i) x[b + 2 * i] = x[b + 2 * i] * DWT_TWO_INVK;
    uint32_t ml = (uint32_t)std::min(sn, dn - a), mh = (uint32_t)std::min(dn, sn - b);
    lift97(x, a, b, (uint32_t)sn, ml, -DWT_DELTA);
    lift97(x, b, a, (uint32_t)dn, mh, -DWT_GAMMA);
    lift97(x, a, b, (uint32_t)sn, ml, -DWT_BETA);
    lift97(x, b, a, (uint32_t)dn, mh, -DWT_ALPHA);
}

// opj_dwt_decode_tile / opj_dwt_decode_tile_97 over the lowest `numres`
// resolutions of the whole tile-component
void idwt_tile(TileComp& tc, bool reversible, uint32_t numres) {
    if (numres <= 1) return;
    const int32_t stride = tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0;
    int32_t rw = tc.res[0].x1 - tc.res[0].x0, rh = tc.res[0].y1 - tc.res[0].y0;
    size_t maxlen = 0;
    for (const Res& r : tc.res)
        maxlen = std::max<size_t>(maxlen, (size_t)std::max(r.x1 - r.x0, r.y1 - r.y0));
    std::vector<int32_t> in(maxlen + 2), out(maxlen + 2);
    std::vector<float> fx(maxlen + 2);
    int32_t* d = tc.data.data();
    float* fd = tc.f();
    for (uint32_t r = 1; r < numres; ++r) {
        const Res& res = tc.res[r];
        int32_t hsn = rw, vsn = rh;
        rw = res.x1 - res.x0;
        rh = res.y1 - res.y0;
        int32_t hcas = res.x0 % 2, vcas = res.y0 % 2;
        int32_t hdn = rw - hsn, vdn = rh - vsn;
        for (int32_t j = 0; j < rh; ++j) {   // rows
            if (reversible) {
                int32_t* row = d + (size_t)j * stride;
                std::copy(row, row + rw, in.begin());
                idwt53_line(in.data(), out.data(), hsn, rw, hcas);
                std::copy(out.begin(), out.begin() + rw, row);
            } else {
                float* row = fd + (size_t)j * stride;
                for (int32_t i = 0; i < hsn; ++i) fx[hcas + 2 * i] = row[i];
                for (int32_t i = 0; i < hdn; ++i) fx[1 - hcas + 2 * i] = row[hsn + i];
                idwt97_line(fx.data(), hsn, hdn, hcas);
                std::copy(fx.begin(), fx.begin() + rw, row);
            }
        }
        for (int32_t i = 0; i < rw; ++i) {   // columns
            if (reversible) {
                for (int32_t j = 0; j < rh; ++j) in[j] = d[(size_t)j * stride + i];
                idwt53_line(in.data(), out.data(), vsn, rh, vcas);
                for (int32_t j = 0; j < rh; ++j) d[(size_t)j * stride + i] = out[j];
            } else {
                for (int32_t j = 0; j < vsn; ++j) fx[vcas + 2 * j] = fd[(size_t)j * stride + i];
                for (int32_t j = 0; j < vdn; ++j)
                    fx[1 - vcas + 2 * j] = fd[(size_t)(vsn + j) * stride + i];
                idwt97_line(fx.data(), vsn, vdn, vcas);
                for (int32_t j = 0; j < rh; ++j) fd[(size_t)j * stride + i] = fx[j];
            }
        }
    }
}

// ---------------------------------------------------------- a whole tile

void Decoder::decode_tile_data(uint32_t tile_no, bool whole_image) {
    Tcp& tcp = tile_tcp(tile_no);
    Tile tile(*this, tcp);
    tile.init(tile_no);
    // tier 2: every packet, in the progression's order
    tile.t2(tcp.data.data(), tcp.data.size());
    // tier 1, dequantisation and the inverse transforms, component by component
    T1 t1;
    for (uint32_t c = 0; c < numcomps; ++c) {
        TileComp& tc = tile.comps[c];
        const Tccp& tccp = tcp.tccps[c];
        const int32_t tw_ = tc.x1 - tc.x0, th_ = tc.y1 - tc.y0;
        tc.data.assign((size_t)tw_ * th_, 0);
        for (uint32_t r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                for (Precinct& pr : band.precs) {
                    for (Cblk& cb : pr.cblks) {
                        if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                        if (!t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty)) refuse();
                        int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        int32_t* dp = t1.data.data();
                        const uint32_t cw = t1.w, ch = t1.h;
                        if (tccp.roishift) {
                            if (tccp.roishift >= 31) {
                                std::fill(t1.data.begin(), t1.data.end(), 0);
                            } else {
                                int32_t thresh = 1 << tccp.roishift;
                                for (int32_t& v : t1.data) {
                                    int32_t mag = std::abs(v);
                                    if (mag >= thresh) {
                                        mag >>= tccp.roishift;
                                        v = v < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        if (tccp.qmfbid == 1) {
                            for (uint32_t j = 0; j < ch; ++j)
                                for (uint32_t i = 0; i < cw; ++i)
                                    tc.data[(size_t)(y + j) * tw_ + x + i] = dp[j * cw + i] / 2;
                        } else {
                            const float step = 0.5f * band.stepsize;
                            float* fd = tc.f();
                            for (uint32_t j = 0; j < ch; ++j)
                                for (uint32_t i = 0; i < cw; ++i)
                                    fd[(size_t)(y + j) * tw_ + x + i] = (float)dp[j * cw + i] * step;
                        }
                    }
                }
            }
        }
        idwt_tile(tc, tccp.qmfbid == 1, tile.resno_decoded[c] + 1);
    }
    // the multiple component transform (opj_tcd_mct_decode)
    if (tcp.mct != 0) {
        if (numcomps >= 3) {
            TileComp &c0 = tile.comps[0], &c1 = tile.comps[1], &c2 = tile.comps[2];
            if (c0.numres != c1.numres || c0.numres != c2.numres) refuse();
            const std::vector<uint32_t>& rd = tile.resno_decoded;
            if (rd[0] != rd[1] || rd[0] != rd[2] ||
                c1.data.size() != c0.data.size() || c2.data.size() != c0.data.size())
                refuse();
            size_t n = c0.data.size();
            if (tcp.tccps[0].qmfbid == 1) {
                for (size_t i = 0; i < n; ++i) {
                    int32_t y = c0.data[i], u = c1.data[i], v = c2.data[i];
                    int32_t g = sub(y, add(u, v) >> 2);
                    c0.data[i] = add(v, g);
                    c1.data[i] = g;
                    c2.data[i] = add(u, g);
                }
            } else {
                float *f0 = c0.f(), *f1 = c1.f(), *f2 = c2.f();
                for (size_t i = 0; i < n; ++i) {
                    float y = f0[i], u = f1[i], v = f2[i];
                    float r = y + (v * 1.402f);
                    float g = y - (u * 0.34413f) - (v * 0.71414f);
                    float b = y + (u * 1.772f);
                    f0[i] = r;
                    f1[i] = g;
                    f2[i] = b;
                }
            }
        }
    }
    // DC level shift and clamp (opj_tcd_dc_level_shift_decode) over the
    // resolution decoded, at the top left of the tile-component's buffer
    for (uint32_t c = 0; c < numcomps; ++c) {
        TileComp& tc = tile.comps[c];
        const Comp& ic = comps[c];
        const Tccp& tccp = tcp.tccps[c];
        const Res& res = tc.res[tile.resno_decoded[c]];
        const int32_t shift = 1 << (ic.prec - 1);
        const int32_t mx = (int32_t)((1u << ic.prec) - 1);
        const int32_t stride = tc.x1 - tc.x0, w = res.x1 - res.x0, h = res.y1 - res.y0;
        float* fd = tc.f();
        for (int32_t j = 0; j < h; ++j) {
            for (int32_t i = 0; i < w; ++i) {
                size_t k = (size_t)j * stride + i;
                if (tccp.qmfbid == 1) {
                    tc.data[k] = std::clamp(add(tc.data[k], shift), 0, mx);
                } else {
                    float f = fd[k];
                    int32_t v;
                    if (f > (float)INT32_MAX) v = mx;
                    else if (f < (float)INT32_MIN) v = 0;
                    else v = (int32_t)std::clamp<int64_t>((int64_t)lrintf(f) + shift, 0, mx);
                    tc.data[k] = v;
                }
            }
        }
    }
    // the tile into the image: a single tile the size of the image is the
    // image, its whole buffer (opj_j2k_decode_tiles); otherwise the decoded
    // resolution's samples go in at that resolution's coordinates
    // (opj_j2k_update_image_data), on a zeroed image
    for (uint32_t c = 0; c < numcomps; ++c) {
        TileComp& tc = tile.comps[c];
        Comp& ic = comps[c];
        ic.decoded = true;
        if (whole_image) {
            ic.data = std::move(tc.data);
            continue;
        }
        if (ic.data.empty()) ic.data.assign((size_t)ic.w * ic.h, 0);
        const Res& res = tc.res[tile.resno_decoded[c]];
        const int64_t stride = tc.x1 - tc.x0;
        for (int64_t y = std::max<int64_t>(res.y0, ic.y0);
             y < std::min<int64_t>(res.y1, (int64_t)ic.y0 + ic.h); ++y)
            for (int64_t x = std::max<int64_t>(res.x0, ic.x0);
                 x < std::min<int64_t>(res.x1, (int64_t)ic.x0 + ic.w); ++x)
                ic.data[(size_t)(y - ic.y0) * ic.w + (size_t)(x - ic.x0)] =
                    tc.data[(size_t)(y - res.y0) * stride + (size_t)(x - res.x0)];
    }
}

}  // namespace

// ---------------------------------------------------------------- the API

struct J2kResult {
    int status = 1;
    std::string message;
    uint32_t numcomps = 0;
    std::vector<Comp> comps;
};

extern "C" {

// Decodes the codestream `data` (a raw J2K file, or what follows a JP2's
// jp2c box header to the end of the file). `ihdr_w`/`ihdr_h`: the JP2's
// image header size, 0 for a raw codestream. Returns a handle whose status
// j2k_status reads; j2k_free releases it.
void* j2k_decode(const uint8_t* data, int64_t len, uint32_t ihdr_w, uint32_t ihdr_h) {
    J2kResult* out = new J2kResult();
    Decoder dec;
    dec.s.d = data;
    dec.s.n = len;
    dec.ihdr_w = ihdr_w;
    dec.ihdr_h = ihdr_h;
    try {
        dec.read_header();
        // cv2's header checks (Jpeg2KOpenJpegDecoder::readHeader) and size limits,
        // and the origin its readData requires: each refuses before any decoding
        if (dec.numcomps < 1 || dec.numcomps > 4) refuse();
        uint32_t maxprec = 0;
        for (const Comp& c : dec.comps) {
            if (c.sgnd) refuse();
            maxprec = std::max(maxprec, c.prec);
        }
        if (maxprec < 8) refuse();
        uint64_t w = dec.x1 - dec.x0, h = dec.y1 - dec.y0;
        if (w > (1u << 20) || h > (1u << 20) || w * h > (1ull << 30)) refuse();
        if (dec.x0 != 0 || dec.y0 != 0) refuse();
        dec.decode_all();
        out->status = 0;
        out->numcomps = dec.numcomps;
        out->comps = std::move(dec.comps);
    } catch (const Refused& e) {
        out->status = 1;
        out->message = "refused at csrc/jpeg2000.cpp:" + std::to_string(e.line);
    } catch (const NotPorted& e) {
        out->status = 2;
        out->message = e.what;
    } catch (const std::bad_alloc&) {
        out->status = 1;
    }
    return out;
}

int j2k_status(void* h) { return static_cast<J2kResult*>(h)->status; }

const char* j2k_message(void* h) { return static_cast<J2kResult*>(h)->message.c_str(); }

// info[0] = number of components; then per component: prec, dx, dy, w, h
void j2k_info(void* h, int64_t* info) {
    J2kResult* r = static_cast<J2kResult*>(h);
    info[0] = r->numcomps;
    for (uint32_t c = 0; c < r->numcomps; ++c) {
        const Comp& k = r->comps[c];
        info[1 + 5 * c] = k.prec;
        info[2 + 5 * c] = k.dx;
        info[3 + 5 * c] = k.dy;
        info[4 + 5 * c] = k.w;
        info[5 + 5 * c] = k.h;
    }
}

void j2k_plane(void* h, int c, int32_t* out) {
    const Comp& k = static_cast<J2kResult*>(h)->comps[c];
    memcpy(out, k.data.data(), k.data.size() * sizeof(int32_t));
}

void j2k_free(void* h) { delete static_cast<J2kResult*>(h); }

}  // extern "C"
