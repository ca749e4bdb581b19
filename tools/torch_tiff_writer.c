/* A TIFF writer over libtiff for the port's TIFF fixtures
 * (tools/make_torch_tiff_webp_fixtures.py): it writes what cv2 cannot.
 *
 *   torch_tiff_writer OUT MODE SPEC DATA
 *
 * MODE is TIFFOpen's ("w", "w8" for BigTIFF, "wb"/"wl" for byte order).
 * SPEC holds one line per field, "TAG V1 V2 ...", applied in order with
 * TIFFSetField; "chunks N1 N2 ..." writes the next chunks of DATA as
 * encoded strips (or tiles when the tile size is set) of those sizes;
 * "page" ends a directory and starts the next. Build:
 *   gcc torch_tiff_writer.c -o torch_tiff_writer -ltiff
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <tiffio.h>

int main(int argc, char** argv) {
  if (argc != 5) { fprintf(stderr, "usage: %s OUT MODE SPEC DATA\n", argv[0]); return 2; }
  TIFF* t = TIFFOpen(argv[1], argv[2]);
  FILE* spec = fopen(argv[3], "r");
  FILE* data = fopen(argv[4], "rb");
  if (!t || !spec || !data) { fprintf(stderr, "cannot open\n"); return 2; }
  char line[1 << 16];
  while (fgets(line, sizeof line, spec)) {
    char* save = NULL;
    char* word = strtok_r(line, " \n", &save);
    if (!word) continue;
    double v[4096];
    int n = 0;
    for (char* w = strtok_r(NULL, " \n", &save); w && n < 4096; w = strtok_r(NULL, " \n", &save))
      v[n++] = atof(w);
    if (!strcmp(word, "page")) { if (!TIFFWriteDirectory(t)) return 1; continue; }
    if (!strcmp(word, "chunks")) {
      int tiled = TIFFIsTiled(t);
      for (int i = 0; i < n; ++i) {
        tmsize_t len = (tmsize_t)v[i];
        unsigned char* buf = malloc(len ? len : 1);
        if (fread(buf, 1, len, data) != (size_t)len) { fprintf(stderr, "short data\n"); return 1; }
        tmsize_t r = tiled ? TIFFWriteEncodedTile(t, i, buf, len)
                           : TIFFWriteEncodedStrip(t, i, buf, len);
        if (r < 0) { fprintf(stderr, "write failed at chunk %d\n", i); return 1; }
        free(buf);
      }
      continue;
    }
    int tag = atoi(word);
    int ok = 1;
    switch (tag) {
      case 256: case 257: case 278: case 322: case 323:
        ok = TIFFSetField(t, tag, (uint32_t)v[0]); break;
      case 338: { uint16_t e[16]; for (int i = 0; i < n; ++i) e[i] = (uint16_t)v[i];
        ok = TIFFSetField(t, tag, (uint16_t)n, e); break; }
      case 320: { int k = n / 3; uint16_t* c = malloc(sizeof(uint16_t) * n);
        for (int i = 0; i < n; ++i) c[i] = (uint16_t)v[i];
        ok = TIFFSetField(t, tag, c, c + k, c + 2 * k); break; }
      case 530: ok = TIFFSetField(t, tag, (uint16_t)v[0], (uint16_t)v[1]); break;
      case 529: case 532: { float f[6]; for (int i = 0; i < n; ++i) f[i] = (float)v[i];
        ok = TIFFSetField(t, tag, f); break; }
      case 65537: case 65538: ok = TIFFSetField(t, tag, (int)v[0]); break;
      default: ok = TIFFSetField(t, tag, (uint16_t)v[0]); break;
    }
    if (!ok) { fprintf(stderr, "TIFFSetField %d failed\n", tag); return 1; }
  }
  TIFFClose(t);
  return 0;
}
