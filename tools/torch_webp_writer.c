/* A WebP writer over libwebp's encoder for the port's WebP fixtures
 * (tools/make_torch_tiff_webp_fixtures.py): the encoder settings cv2's
 * imencode does not expose.
 *
 *   torch_webp_writer OUT W H RGBA KEY=VALUE...
 *
 * RGBA holds W*H*4 bytes. Keys (all integers): lossless, quality, method,
 * segments, partitions (log2 of the count), filter_type (0 simple, 1
 * strong), filter_sharpness, filter_strength, sns, alpha_quality,
 * alpha_compression, alpha_filtering, exact, autofilter. Build:
 *   gcc torch_webp_writer.c -o torch_webp_writer -lwebp
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

int main(int argc, char** argv) {
  if (argc < 5) { fprintf(stderr, "usage: %s OUT W H RGBA KEY=VALUE...\n", argv[0]); return 2; }
  const int w = atoi(argv[2]), h = atoi(argv[3]);
  FILE* in = fopen(argv[4], "rb");
  unsigned char* rgba = malloc((size_t)w * h * 4);
  if (!in || fread(rgba, 1, (size_t)w * h * 4, in) != (size_t)w * h * 4) {
    fprintf(stderr, "bad input\n");
    return 2;
  }
  WebPConfig config;
  if (!WebPConfigInit(&config)) return 1;
  for (int i = 5; i < argc; ++i) {
    char* eq = strchr(argv[i], '=');
    if (!eq) return 2;
    *eq = 0;
    const int v = atoi(eq + 1);
    const char* k = argv[i];
    if (!strcmp(k, "lossless")) config.lossless = v;
    else if (!strcmp(k, "quality")) config.quality = (float)v;
    else if (!strcmp(k, "method")) config.method = v;
    else if (!strcmp(k, "segments")) config.segments = v;
    else if (!strcmp(k, "partitions")) config.partitions = v;
    else if (!strcmp(k, "filter_type")) config.filter_type = v;
    else if (!strcmp(k, "filter_sharpness")) config.filter_sharpness = v;
    else if (!strcmp(k, "filter_strength")) config.filter_strength = v;
    else if (!strcmp(k, "sns")) config.sns_strength = v;
    else if (!strcmp(k, "alpha_quality")) config.alpha_quality = v;
    else if (!strcmp(k, "alpha_compression")) config.alpha_compression = v;
    else if (!strcmp(k, "alpha_filtering")) config.alpha_filtering = v;
    else if (!strcmp(k, "exact")) config.exact = v;
    else if (!strcmp(k, "autofilter")) config.autofilter = v;
    else { fprintf(stderr, "unknown key %s\n", k); return 2; }
  }
  if (!WebPValidateConfig(&config)) { fprintf(stderr, "bad config\n"); return 1; }
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 1;
  pic.width = w;
  pic.height = h;
  pic.use_argb = config.lossless;
  if (!WebPPictureImportRGBA(&pic, rgba, w * 4)) return 1;
  WebPMemoryWriter mw;
  WebPMemoryWriterInit(&mw);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &mw;
  if (!WebPEncode(&config, &pic)) {
    fprintf(stderr, "encode failed %d\n", pic.error_code);
    return 1;
  }
  FILE* out = fopen(argv[1], "wb");
  fwrite(mw.mem, 1, mw.size, out);
  fclose(out);
  return 0;
}
