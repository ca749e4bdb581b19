// VP8 key frames as libwebp decodes them (vp8_dec.c, tree_dec.c,
// quant_dec.c, frame_dec.c, dsp/dec.c), then libwebp's default RGB output
// (io_dec.c EmitFancyRGB, dsp/upsampling.c, yuv.h), for the port's WebP
// decoder (utils/webp.py): the boolean decoder (its prob-128 sign read
// included, whose state after a zero differs from a general read's), the
// frame, segment and filter headers, the token partitions, the
// quantisers, the coefficient probabilities with their updates and the
// skip flag, the intra modes (16x16, 4x4 with the top-right taken from the
// macroblock above and to the right, chroma), the inverse WHT and DCT (the
// DCT as libwebp's x86 build runs it: 16-bit wrapping, which only a damaged
// stream can reach), the simple and normal loop filters with their per-segment and mode deltas,
// then fancy upsampling of the chroma and the 14-bit YUV to BGR. The
// decoder keeps one frame's state (Frame) so that inter frames can be
// added beside key frames. Plain C interface, bound with ctypes, built
// with g++ at first use (utils/host_build.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// RFC 6386 13.5 default_coeff_probs [4][8][3][11]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 13.4 coeff_update_probs [4][8][3][11]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 11.5 kf_bmode_probs [above][left][9], modes in the order
// DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
    63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83,
    84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114,
    116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84,
    86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125,
    128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259,
    264, 269, 274, 279, 284};

// libwebp's mode numbers: 4x4 modes, and the 16x16 / chroma ones on the same values
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, V_PRED = B_VE, H_PRED = B_HE, TM_PRED = B_TM };

// VP8BitReader with one byte loaded at a time (libwebp loads 56 bits where
// it can; the window and the end-of-data flag come out the same).
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;

  void init(const uint8_t* p, int64_t n) {
    buf = p;
    end = p + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  static int log2floor(uint32_t n) { return 31 - __builtin_clz(n); }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ log2floor(r);
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int signed_value(int v) {   // VP8GetSigned
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t literal(int n) {   // VP8GetValue
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get(0x80)) << n;
    return v;
  }
  int32_t signed_literal(int n) {   // VP8GetSignedValue
    const int32_t v = static_cast<int32_t>(literal(n));
    return get(0x80) ? -v : v;
  }
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MB {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

// One decoded frame and the state that produced it.
struct Frame {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // headers
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int8_t quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int num_parts = 1;
  BoolReader br, parts[8];
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t probas[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrength[4][2];
  // planes: unfiltered reconstruction, then filtered in place
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> y, u, v;
  std::vector<FInfo> finfo;   // per macroblock
};

int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

bool parse_headers(Frame& f, const uint8_t* buf, int64_t size) {
  if (size < 10) return false;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key || profile > 3 || !show) return false;
  buf += 3;
  size -= 3;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return false;
  f.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  f.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  memcpy(f.probas, kCoeffsProba0, sizeof f.probas);
  if (part0 > size) return false;
  BoolReader& br = f.br;
  br.init(buf, part0);
  buf += part0;
  size -= part0;
  br.get(0x80);   // colour space
  br.get(0x80);   // clamping type
  // segment header
  f.use_segment = br.get(0x80);
  if (f.use_segment) {
    f.update_map = br.get(0x80);
    if (br.get(0x80)) {
      f.absolute_delta = br.get(0x80);
      for (int s = 0; s < 4; ++s) f.quantizer[s] = br.get(0x80) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) f.filter_strength[s] = br.get(0x80) ? br.signed_literal(6) : 0;
    }
    if (f.update_map)
      for (int s = 0; s < 3; ++s) f.segment_probs[s] = br.get(0x80) ? br.literal(8) : 255;
  } else {
    f.update_map = 0;
  }
  if (br.eof) return false;
  // filter header
  f.simple = br.get(0x80);
  f.level = br.literal(6);
  f.sharpness = br.literal(3);
  f.use_lf_delta = br.get(0x80);
  if (f.use_lf_delta && br.get(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) f.ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(0x80)) f.mode_lf_delta[i] = br.signed_literal(6);
  }
  f.filter_type = f.level == 0 ? 0 : f.simple ? 1 : 2;
  if (br.eof) return false;
  // partitions
  f.num_parts = 1 << br.literal(2);
  const int last = f.num_parts - 1;
  if (size < 3 * last) return false;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  int64_t left = size - 3 * last;
  for (int p = 0; p < last; ++p) {
    int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    f.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  f.parts[last].init(start, left);
  if (start >= buf + size) return false;
  // quantisers
  const int base = br.literal(7);
  const int dqy1_dc = br.get(0x80) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.get(0x80) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.get(0x80) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.get(0x80) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.get(0x80) ? br.signed_literal(4) : 0;
  auto clipq = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (f.use_segment) {
      q = f.quantizer[i];
      if (!f.absolute_delta) q += base;
    } else if (i > 0) {
      memcpy(f.y1[i], f.y1[0], sizeof f.y1[0]);
      memcpy(f.y2[i], f.y2[0], sizeof f.y2[0]);
      memcpy(f.uv[i], f.uv[0], sizeof f.uv[0]);
      continue;
    } else {
      q = base;
    }
    f.y1[i][0] = kDcTable[clipq(q + dqy1_dc, 127)];
    f.y1[i][1] = kAcTable[clipq(q, 127)];
    f.y2[i][0] = kDcTable[clipq(q + dqy2_dc, 127)] * 2;
    f.y2[i][1] = (kAcTable[clipq(q + dqy2_ac, 127)] * 101581) >> 16;
    if (f.y2[i][1] < 8) f.y2[i][1] = 8;
    f.uv[i][0] = kDcTable[clipq(q + dquv_dc, 117)];
    f.uv[i][1] = kAcTable[clipq(q + dquv_ac, 127)];
  }
  br.get(0x80);   // refresh entropy probs: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          f.probas[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                     ? br.literal(8)
                                     : kCoeffsProba0[t][b][c][p];
  f.use_skip = br.get(0x80);
  if (f.use_skip) f.skip_p = br.literal(8);
  return true;
}

void filter_strengths(Frame& f) {
  if (f.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base;
    if (f.use_segment) {
      base = f.filter_strength[s];
      if (!f.absolute_delta) base += f.level;
    } else {
      base = f.level;
    }
    for (int i4 = 0; i4 <= 1; ++i4) {
      FInfo& info = f.fstrength[s][i4];
      int level = base;
      if (f.use_lf_delta) {
        level += f.ref_lf_delta[0];
        if (i4) level += f.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (f.sharpness > 0) {
          ilevel >>= f.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - f.sharpness) ilevel = 9 - f.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4;
    }
  }
}

void parse_intra(Frame& f, BoolReader& br, MBData& b, uint8_t* top, uint8_t* left) {
  if (f.update_map) {
    b.segment = !br.get(f.segment_probs[0]) ? br.get(f.segment_probs[1])
                                            : br.get(f.segment_probs[2]) + 2;
  } else {
    b.segment = 0;
  }
  b.skip = f.use_skip ? br.get(f.skip_p) : 0;
  b.is_i4x4 = !br.get(145);
  if (!b.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                  : (br.get(163) ? V_PRED : DC_PRED);
    b.imodes[0] = static_cast<uint8_t>(ymode);
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !br.get(prob[0]) ? B_DC
              : !br.get(prob[1]) ? B_TM
              : !br.get(prob[2]) ? B_VE
              : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
              : (!br.get(prob[6]) ? B_LD
                 : (!br.get(prob[7]) ? B_VL : (!br.get(prob[8]) ? B_HD : B_HU)));
        top[x] = static_cast<uint8_t>(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  b.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
}

int large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// GetCoeffs: returns the position after the last non-zero coefficient
int get_coeffs(BoolReader& br, const uint8_t (*band)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = band[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = band[kBands[n + 1]];
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(br.signed_value(v) * dq[n > 0]);
  }
  return 16;
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ParseResiduals: returns whether the macroblock has no non-zero coefficient
int parse_residuals(Frame& f, MB& mb, MB& left, BoolReader& br, MBData& b) {
  const int s = b.segment;
  int16_t* dst = b.coeffs;
  memset(dst, 0, sizeof b.coeffs);
  int first;
  const uint8_t (*ac)[3][11];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, f.probas[1], ctx, f.y2[s], 0, dc);
    mb.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac = f.probas[0];
  } else {
    first = 0;
    ac = f.probas[3];
  }
  uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac, ctx, f.y1[s], first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint8_t>(mb.nz >> (4 + ch));
    lnz = static_cast<uint8_t>(left.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, f.probas[2], ctx, f.uv[s], 0, dst);
        l = nz > 0;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
    out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
  }
  mb.nz = static_cast<uint8_t>(out_t_nz);
  left.nz = static_cast<uint8_t>(out_l_nz);
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ------------------------------------------------------- reconstruction

constexpr int BPS = 32;   // the work buffer's stride, as libwebp's

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip8(top[x] + l - tl));
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, static_cast<int>(dc >> 3), 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const uint8_t r[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, r[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:   // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
  }
}
#undef DST

// 16x16 (size 16) and chroma (size 8) prediction, DC by the edges present
void predict_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case TM_PRED: true_motion(dst, size); break;
    default: {
      int dc;
      if (mb_x > 0 && mb_y > 0) {
        dc = size;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        dc >>= shift;
      } else if (mb_y > 0) {   // no left
        dc = size / 2;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        dc >>= shift - 1;
      } else if (mb_x > 0) {   // no top
        dc = size / 2;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        dc >>= shift - 1;
      } else {
        dc = 0x80;
      }
      fill(dst, dc, size);
    }
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne as libwebp's x86 build runs it (Transform_SSE2): the C
// arithmetic with every intermediate wrapped to 16 bits (the constants as
// 20091 and 35468 - 65536 through mulhi, plus the input), the sum with the
// prediction wrapped, then saturated to 8 bits. Equal to the C routine on
// any coefficients a valid stream carries.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return static_cast<int16_t>((a * k) >> 16); }

void transform_one(const int16_t* in, uint8_t* dst) {
  int16_t t[4][4];   // t[r][i]: the vertical pass's output r of column i
  for (int i = 0; i < 4; ++i) {
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[0][i] = w16(a + d);
    t[1][i] = w16(b + c);
    t[2][i] = w16(b - c);
    t[3][i] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {   // row r of the output, from t[r][0..3]
    const int16_t T0 = t[r][0], T1 = t[r][1], T2 = t[r][2], T3 = t[r][3];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t v[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    uint8_t* row = dst + r * BPS;
    for (int x = 0; x < 4; ++x) row[x] = static_cast<uint8_t>(clip8(w16(row[x] + (v[x] >> 3))));
  }
}

// TransformAC3_C: in[0], in[1] and in[4] only, in int arithmetic
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * BPS;
    const int v[4] = {dcs[y] + d1, dcs[y] + c1, dcs[y] - c1, dcs[y] - d1};
    for (int x = 0; x < 4; ++x) row[x] = static_cast<uint8_t>(clip8(row[x] + (v[x] >> 3)));
  }
}

// TransformDC_C
void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[x + y * BPS] = static_cast<uint8_t>(clip8(dst[x + y * BPS] + (dc >> 3)));
}

// DoTransform: the block's 2-bit code from NzCodeBits picks the routine
void do_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_one(in, dst); break;
    case 2: transform_ac3(in, dst); break;
    case 1: transform_dc(in, dst); break;
    default: break;
  }
}

// DoUVTransform: all four blocks by the full routine if any has an AC
// coefficient, else all four by the DC one
void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa)
      transform_one(src + n * 16, d);
    else
      transform_dc(src + n * 16, d);
  }
}

// Reconstructs one row of macroblocks into the frame planes (unfiltered),
// as ReconstructRow lays out its work buffer: 127 above the picture, 129
// left of it, the 4x4 top-right from the macroblock above and to the right
// (its last pixel on the rightmost column).
void reconstruct_row(Frame& f, int mb_y, const MBData* row) {
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* const y_dst = ybuf + BPS + 8;
  uint8_t* const u_dst = ubuf + BPS + 8;
  uint8_t* const v_dst = vbuf + BPS + 8;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
    const MBData& b = row[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    const uint8_t* ytop = f.y.data() + int64_t(mb_y * 16 - 1) * f.ystride + mb_x * 16;
    const uint8_t* utop = f.u.data() + int64_t(mb_y * 8 - 1) * f.uvstride + mb_x * 8;
    const uint8_t* vtop = f.v.data() + int64_t(mb_y * 8 - 1) * f.uvstride + mb_x * 8;
    if (mb_y > 0) {
      memcpy(y_dst - BPS, ytop, 16);
      memcpy(u_dst - BPS, utop, 8);
      memcpy(v_dst - BPS, vtop, 8);
    }
    const int16_t* coeffs = b.coeffs;
    if (b.is_i4x4) {
      uint8_t* top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= f.mb_w - 1)
          memset(top_right, ytop[15], 4);
        else
          memcpy(top_right, ytop + 16, 4);
      }
      for (int k = 1; k <= 3; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
      uint32_t bits = b.non_zero_y;
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, b.imodes[n]);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      predict_block(y_dst, 16, b.imodes[0], mb_x, mb_y);
      uint32_t bits = b.non_zero_y;
      for (int n = 0; n < 16; ++n, bits <<= 2)
        do_transform(bits, coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    predict_block(u_dst, 8, b.uvmode, mb_x, mb_y);
    predict_block(v_dst, 8, b.uvmode, mb_x, mb_y);
    do_uv_transform(b.non_zero_uv, coeffs + 256, u_dst);
    do_uv_transform(b.non_zero_uv >> 8, coeffs + 320, v_dst);
    uint8_t* yo = f.y.data() + int64_t(mb_y * 16) * f.ystride + mb_x * 16;
    for (int j = 0; j < 16; ++j) memcpy(yo + int64_t(j) * f.ystride, y_dst + j * BPS, 16);
    uint8_t* uo = f.u.data() + int64_t(mb_y * 8) * f.uvstride + mb_x * 8;
    uint8_t* vo = f.v.data() + int64_t(mb_y * 8) * f.uvstride + mb_x * 8;
    for (int j = 0; j < 8; ++j) {
      memcpy(uo + int64_t(j) * f.uvstride, u_dst + j * BPS, 8);
      memcpy(vo + int64_t(j) * f.uvstride, v_dst + j * BPS, 8);
    }
  }
}

// ------------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // VP8ksclip2

void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
}

void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a2));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a3));
}

void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip8(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip8(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip8(p0 + a1));
  p[0] = static_cast<uint8_t>(clip8(q0 - a1));
  p[step] = static_cast<uint8_t>(clip8(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip8(q2 - a3));
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t))
        do_filter2(p, hstride);
      else if (edge)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
    p += vstride;
  }
}

void filter_mb(Frame& f, int mb_x, int mb_y) {
  const FInfo& fi = f.finfo[int64_t(mb_y) * f.mb_w + mb_x];
  const int limit = fi.limit;
  if (limit == 0) return;
  const int ys = f.ystride, uvs = f.uvstride;
  uint8_t* y = f.y.data() + int64_t(mb_y * 16) * ys + mb_x * 16;
  if (f.filter_type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (fi.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (fi.inner)
      for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = f.u.data() + int64_t(mb_y * 8) * uvs + mb_x * 8;
  uint8_t* v = f.v.data() + int64_t(mb_y * 8) * uvs + mb_x * 8;
  const int il = fi.ilevel, ht = fi.hev;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
    filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
    filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (fi.inner) {
    for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
    filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
    filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
    filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
    filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (fi.inner) {
    for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

// ----------------------------------------------------------- YUV to BGR

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip_yuv(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = static_cast<uint8_t>(clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  bgr[1] = static_cast<uint8_t>(
      clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  bgr[0] = static_cast<uint8_t>(clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// UpsampleRgbLinePair for one output row: `near` is the chroma row on the
// row's side of the pair, `far` the other (the same row at the edges).
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, uint8_t* out) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = nu[0], tl_v = nv[0], l_u = fu[0], l_v = fv[0];
  yuv_to_bgr(y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, out);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = nu[x], t_v = nv[x], c_u = fu[x], c_v = fv[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_bgr(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, out + 3 * (2 * x - 1));
    yuv_to_bgr(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, out + 3 * (2 * x));
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1))
    yuv_to_bgr(y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               out + 3 * (len - 1));
}

}  // namespace

extern "C" {

// A VP8 key frame (`data` from the VP8 payload to the end of the buffer,
// as libwebp reads it): the w x h frame as BGR into `bgr`. Returns 0; -1
// for a frame header libwebp refuses, -2 for a frame of another size, -3
// when the data ends before the frame (libwebp's end-of-partition errors).
int vp8_decode(const uint8_t* data, int64_t len, int w, int h, uint8_t* bgr) {
  Frame f;
  if (!parse_headers(f, data, len)) return -1;
  if (f.width != w || f.height != h) return -2;
  f.ystride = f.mb_w * 16;
  f.uvstride = f.mb_w * 8;
  f.y.assign(static_cast<size_t>(f.ystride) * f.mb_h * 16, 0);
  f.u.assign(static_cast<size_t>(f.uvstride) * f.mb_h * 8, 0);
  f.v.assign(static_cast<size_t>(f.uvstride) * f.mb_h * 8, 0);
  f.finfo.assign(static_cast<size_t>(f.mb_w) * f.mb_h, FInfo());
  filter_strengths(f);
  std::vector<uint8_t> intra_t(4 * f.mb_w, B_DC);
  std::vector<MB> mbs(f.mb_w);
  std::vector<MBData> row(f.mb_w);
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    BoolReader& tokens = f.parts[mb_y & (f.num_parts - 1)];
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
      parse_intra(f, f.br, row[mb_x], intra_t.data() + 4 * mb_x, intra_l);
    if (f.br.eof) return -3;
    MB left;
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      MB& mb = mbs[mb_x];
      int skip = f.use_skip ? b.skip : 0;
      if (!skip) {
        skip = parse_residuals(f, mb, left, tokens, b);
      } else {
        left.nz = mb.nz = 0;
        if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        b.non_zero_y = b.non_zero_uv = 0;
        memset(b.coeffs, 0, sizeof b.coeffs);
      }
      if (f.filter_type > 0) {
        FInfo fi = f.fstrength[b.segment][b.is_i4x4];
        fi.inner |= !skip;
        f.finfo[int64_t(mb_y) * f.mb_w + mb_x] = fi;
      }
      if (tokens.eof) return -3;
    }
    reconstruct_row(f, mb_y, row.data());
  }
  if (f.filter_type > 0)
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) filter_mb(f, mb_x, mb_y);
  // EmitFancyRGB: row 0 and an even height's last row from one chroma row
  const int ys = f.ystride, cs = f.uvstride;
  for (int y = 0; y < h; ++y) {
    int near_c, far_c;
    if (y == 0) {
      near_c = far_c = 0;
    } else if (y & 1) {
      near_c = (y - 1) >> 1;
      far_c = y + 1 < h ? (y + 1) >> 1 : near_c;
    } else {
      near_c = y >> 1;
      far_c = (y >> 1) - 1;
    }
    upsample_row(f.y.data() + int64_t(y) * ys, f.u.data() + int64_t(near_c) * cs,
                 f.v.data() + int64_t(near_c) * cs, f.u.data() + int64_t(far_c) * cs,
                 f.v.data() + int64_t(far_c) * cs, w, bgr + int64_t(y) * w * 3);
  }
  return 0;
}

}  // extern "C"
