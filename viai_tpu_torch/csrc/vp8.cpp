// VP8 (RFC 6386) video decoder of viai_tpu_torch, for the VP8 streams
// that cv2 reads through libavcodec (Matroska/WebM CodecID V_VP8, AVI
// fourcc VP80). VP8 reconstruction is exact by specification (integer
// transforms, filters and loop filter), so this decoder computes what
// the RFC computes and gives libavcodec's pictures:
//
//   * the frame tag (keyframe, version, show_frame, first partition
//     size) and the keyframe start code and size; its scaling bits are
//     ignored for the output size, as ffmpeg ignores them;
//   * the boolean entropy decoder (§7) and the frame header (§9, §19.2):
//     the loop filter's type, level, sharpness and mode/reference deltas,
//     1, 2, 4 or 8 token partitions, the quantiser indices and deltas,
//     golden/altref refresh, copy and sign bias, refresh_entropy_probs
//     (the probabilities saved before the frame's updates and restored
//     after it), refresh_last, the coefficient, mode and MV probability
//     updates, mb_no_coeff_skip; segmentation (the map with its tree
//     probabilities, kept from frame to frame until updated, and each
//     segment's quantiser and level deltas, applied as ffmpeg applies
//     them: added to the frame's before the clamp);
//   * per macroblock (§16, §17): the segment, the skip flag, keyframe
//     intra modes with the contextual B_PRED sub-modes, inter-frame intra
//     modes, the reference frame, the near/nearest search with sign bias
//     and the mode contexts, split MVs in their four partitionings, MV
//     decoding;
//   * tokens (§13) with the above/left non-zero contexts, dequantisation
//     with the Y2 and UV clamps (§14.1), the inverse WHT and the exact
//     IDCT (§14.3, §14.4);
//   * intra prediction (§12): 16x16, chroma and 4x4, whose right-hand
//     column takes its above-right pixels from the macroblock row above
//     (the last pixel of that row repeated past the picture); 127 above
//     the picture and 129 left of it; from the frame before its loop
//     filter;
//   * inter prediction (§18): the six-tap filters for version 0,
//     bilinear for versions 1 and 2, full-pixel chroma for version 3;
//     chroma MVs from the luma MVs with the spec's rounding; references
//     read beyond their 16-aligned planes as their edge pixels repeated;
//   * the normal and simple loop filters (§15) over the whole frame in
//     the spec's edge order, with per-segment and per-reference/mode
//     levels, interior and edge limits and the high-edge-variance
//     thresholds;
//   * the last, golden and altref references (§9.7-9.8); a hidden frame
//     (show_frame 0) is decoded and kept as a reference but gives no
//     picture, as libavcodec gives none;
//   * the picture: the 16-aligned planes cropped to the coded size,
//     yuv420p at limited range.
//
// What libvpx does not write, and so no fixture of the tests holds,
// raises NotImplementedError (code 2) naming it, detected from the frame
// header: versions past 3, colour space 1, clamping type 1, segment data
// in absolute values, a keyframe that keeps an earlier segment map, a
// sign bias on the golden frame, a golden frame copied from another
// reference, an altref frame copied from the last one, and frames
// without mb_no_coeff_skip.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "video.h"

namespace viai_video {

namespace {

// ---------------------------------------------------------------- tables

// §14.1: quantiser index → DC and AC step.
const uint8_t kDcQ[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,
    17,  17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,
    25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,
    38,  39,  40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,
    51,  52,  53,  54,  55,  56,  57,  58,  59,  60,  61,  62,  63,  64,
    65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  76,  77,
    78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,  91,  93,
    95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
    154, 157};
const uint16_t kAcQ[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,
    18,  19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,
    32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,
    46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,
    62,  64,  66,  68,  70,  72,  74,  76,  78,  80,  82,  84,  86,  88,
    90,  92,  94,  96,  98,  100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284};

// §13.5: default token probabilities [block type][band][context][node].
const uint8_t kCoefDefault[4][8][3][11] = {
    {  // block type 0
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {  // block type 1
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {  // block type 2
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {  // block type 3
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};

// §13.4: probabilities that a token probability is updated.
const uint8_t kCoefUpdate[4][8][3][11] = {
    {  // block type 0
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {  // block type 1
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {  // block type 2
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {  // block type 3
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};

// §11.5: keyframe sub-block mode probabilities [above][left].
const uint8_t kKfBmodeProb[10][10][9] = {
    {
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36},
    },
    {
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22},
    },
    {
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51},
    },
    {
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82},
    },
    {
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26},
    },
    {
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47},
    },
    {
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98},
    },
    {
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40},
    },
    {
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128},
    },
    {
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24},
    },
};

const uint8_t kBmodeProb[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
const uint8_t kKfYmodeProb[4] = {145, 156, 163, 128};
const uint8_t kYmodeProb[4] = {112, 86, 140, 37};
const uint8_t kKfUvModeProb[3] = {142, 114, 183};
const uint8_t kUvModeProb[3] = {162, 101, 204};

// §17.2: MV probabilities of each component (row, then column):
// is_short, sign, the short tree (7), the long bits (10).
const uint8_t kMvDefault[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145,
     178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148,
     180, 203, 236, 254, 254}};
const uint8_t kMvUpdate[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254,
     251, 251, 254, 254, 254}};

// §16.3: mode contexts [count][tree node]; split MV probabilities.
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},    {14, 18, 14, 107},
                                     {135, 64, 57, 68}, {60, 56, 128, 65},
                                     {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kSubMvRefProb[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
const uint8_t kMbSplitProb[3] = {110, 111, 150};
// Partitionings 16x8 (top/bottom), 8x16 (left/right), 8x8 and 4x4:
// each luma sub-block's partition.
const uint8_t kMbSplits[4][16] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const int kMbSplitCount[4] = {2, 2, 4, 16};

// §13: coefficient bands, zigzag order, extra-bit categories 3-6.
const uint8_t kBands[16] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCatProb[4] = {kCat3, kCat4, kCat5, kCat6};
const int kCatBase[4] = {11, 19, 35, 67};

// §18.3: the six-tap filters by eighth-pel fraction.
const int kSixtap[8][6] = {
    {0, 0, 128, 0, 0, 0},     {0, -6, 123, 12, -1, 0},
    {2, -11, 108, 36, -8, 1}, {0, -9, 93, 50, -6, 0},
    {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
    {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

// Modes: intra 16x16, B_PRED, inter; sub-block modes; references.
enum : uint8_t { kDc, kV, kH, kTm, kB, kNearest, kNear, kZero, kNew, kSplit };
enum : uint8_t { kBDc, kBTm, kBVe, kBHe, kBLd, kBRd, kBVr, kBVl, kBHd, kBHu };
enum : uint8_t { kIntra, kLast, kGolden, kAltref };

// §8.1 trees: an inner node gives the index of its pair, a leaf −value.
const int8_t kKfYmodeTree[8] = {-kB, 2, 4, 6, -kDc, -kV, -kH, -kTm};
const int8_t kYmodeTree[8] = {-kDc, 2, 4, 6, -kV, -kH, -kTm, -kB};
const int8_t kUvModeTree[6] = {-kDc, 2, -kV, 4, -kH, -kTm};
const int8_t kBmodeTree[18] = {-kBDc, 2,     -kBTm, 4,     -kBVe, 6,
                               8,     12,    -kBHe, 10,    -kBRd, -kBVr,
                               -kBLd, 14,    -kBVl, 16,    -kBHd, -kBHu};
const int8_t kSegmentTree[6] = {2, 4, 0, -1, -2, -3};
const int8_t kSmallMvTree[14] = {2, 8, 4, 6, 0, -1, -2, -3, 10, 12, -4, -5,
                                 -6, -7};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}
inline uint8_t clip8(int v) { return uint8_t(clampi(v, 0, 255)); }
inline int sclip8(int v) { return clampi(v, -128, 127); }

// ------------------------------------------------------ boolean decoder

// §7.3's decoder with its window widened: `value_` holds the coded bits
// read so far, the top ones aligned with the range `bits_` bits up, and
// is refilled 7 bytes at a time (zeros past the end, as §7.3 reads);
// `range_` holds range − 1, so the split is range_ · prob / 256 and a one
// is coded when the window's value exceeds it.
class BoolDecoder {
 public:
  void init(const uint8_t* d, size_t n) {
    p_ = d;
    end_ = d + n;
    value_ = 0;
    bits_ = -8;
    range_ = 254;
    load();
  }

  int get(int prob) {
    if (bits_ < 0) load();
    uint32_t split = (range_ * uint32_t(prob)) >> 8;
    int bit = uint32_t(value_ >> bits_) > split;
    uint32_t range;
    if (bit) {
      range = range_ - split;
      value_ -= uint64_t(split + 1) << bits_;
    } else {
      range = split + 1;
    }
    int shift = __builtin_clz(range) - 24;        // to range ≥ 128
    range_ = (range << shift) - 1;
    bits_ -= shift;
    return bit;
  }

  int bit() { return get(128); }

  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit();
    return v;
  }

  // A flag; when set, an n-bit magnitude and its sign; else 0.
  int delta(int n) {
    if (!bit()) return 0;
    int v = literal(n);
    return bit() ? -v : v;
  }

  int tree(const int8_t* t, const uint8_t* p) {
    int i = 0;
    while ((i = t[i + get(p[i >> 1])]) > 0) {
    }
    return -i;
  }

 private:
  void load() {
    if (end_ - p_ >= 7) {
      uint64_t b = 0;
      for (int i = 0; i < 7; ++i) b = (b << 8) | p_[i];
      p_ += 7;
      value_ = (value_ << 56) | b;
      bits_ += 56;
    } else {
      value_ = (value_ << 8) | (p_ < end_ ? *p_++ : 0);
      bits_ += 8;
    }
  }

  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
};

// ------------------------------------------------------------ transforms

// §14.3: the inverse WHT of the Y2 block → each luma block's DC.
void inverse_wht(const int16_t in[16], int16_t out[16][16]) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    int a1 = in[i] + in[12 + i], b1 = in[4 + i] + in[8 + i];
    int c1 = in[4 + i] - in[8 + i], d1 = in[i] - in[12 + i];
    t[i] = int16_t(a1 + b1);
    t[4 + i] = int16_t(c1 + d1);
    t[8 + i] = int16_t(a1 - b1);
    t[12 + i] = int16_t(d1 - c1);
  }
  for (int i = 0; i < 4; ++i) {
    const int16_t* r = t + 4 * i;
    int a1 = r[0] + r[3], b1 = r[1] + r[2];
    int c1 = r[1] - r[2], d1 = r[0] - r[3];
    out[4 * i][0] = int16_t((a1 + b1 + 3) >> 3);
    out[4 * i + 1][0] = int16_t((c1 + d1 + 3) >> 3);
    out[4 * i + 2][0] = int16_t((a1 - b1 + 3) >> 3);
    out[4 * i + 3][0] = int16_t((d1 - c1 + 3) >> 3);
  }
}

inline int mul_cos(int a) { return a + ((a * 20091) >> 16); }
inline int mul_sin(int a) { return (a * 35468) >> 16; }

// §14.4: the exact inverse DCT of a block, added to `dst`.
void idct_add4(const int16_t in[16], uint8_t* dst, int stride) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    int a1 = in[i] + in[8 + i], b1 = in[i] - in[8 + i];
    int c1 = mul_sin(in[4 + i]) - mul_cos(in[12 + i]);
    int d1 = mul_cos(in[4 + i]) + mul_sin(in[12 + i]);
    t[i] = int16_t(a1 + d1);
    t[12 + i] = int16_t(a1 - d1);
    t[4 + i] = int16_t(b1 + c1);
    t[8 + i] = int16_t(b1 - c1);
  }
  for (int i = 0; i < 4; ++i) {
    const int16_t* r = t + 4 * i;
    int a1 = r[0] + r[2], b1 = r[0] - r[2];
    int c1 = mul_sin(r[1]) - mul_cos(r[3]);
    int d1 = mul_cos(r[1]) + mul_sin(r[3]);
    uint8_t* o = dst + i * stride;
    o[0] = clip8(o[0] + ((a1 + d1 + 4) >> 3));
    o[3] = clip8(o[3] + ((a1 - d1 + 4) >> 3));
    o[1] = clip8(o[1] + ((b1 + c1 + 4) >> 3));
    o[2] = clip8(o[2] + ((b1 - c1 + 4) >> 3));
  }
}

bool any_coef(const int16_t b[16]) {
  for (int i = 0; i < 16; ++i)
    if (b[i]) return true;
  return false;
}

// ----------------------------------------------------------- loop filter

// p at q0, `s` the step across the edge.
inline bool simple_limit(const uint8_t* p, int s, int e) {
  return std::abs(p[-s] - p[0]) * 2 + (std::abs(p[-2 * s] - p[s]) >> 1) <=
         e;
}

inline bool normal_limit(const uint8_t* p, int s, int e, int i) {
  int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
  return simple_limit(p, s, e) && std::abs(p3 - p2) <= i &&
         std::abs(p2 - p1) <= i && std::abs(p1 - p0) <= i &&
         std::abs(q3 - q2) <= i && std::abs(q2 - q1) <= i &&
         std::abs(q1 - q0) <= i;
}

inline bool high_variance(const uint8_t* p, int s, int t) {
  return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
}

// §15.2 common_adjust: the two pixels at the edge; without the outer
// taps (a sub-block edge of low variance) the next two as well.
inline void filter_common(uint8_t* p, int s, bool outer) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  int a = 3 * (q0 - p0);
  if (outer) a += sclip8(p1 - q1);
  a = sclip8(a);
  int f1 = std::min(a + 4, 127) >> 3, f2 = std::min(a + 3, 127) >> 3;
  p[-s] = clip8(p0 + f2);
  p[0] = clip8(q0 - f1);
  if (!outer) {
    a = (f1 + 1) >> 1;
    p[-2 * s] = clip8(p1 + a);
    p[s] = clip8(q1 - a);
  }
}

// §15.3 MBfilter without high edge variance: three pixels each side.
inline void filter_mbedge(uint8_t* p, int s) {
  int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
  int q0 = p[0], q1 = p[s], q2 = p[2 * s];
  int w = sclip8(sclip8(p1 - q1) + 3 * (q0 - p0));
  int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7,
      a2 = (9 * w + 63) >> 7;
  p[-3 * s] = clip8(p2 + a2);
  p[-2 * s] = clip8(p1 + a1);
  p[-s] = clip8(p0 + a0);
  p[0] = clip8(q0 - a0);
  p[s] = clip8(q1 - a1);
  p[2 * s] = clip8(q2 - a2);
}

// `n` pixels along an edge starting at p, `a` the step along it.
void mb_edge(uint8_t* p, int a, int s, int n, int e, int i, int hev) {
  for (int k = 0; k < n; ++k, p += a)
    if (normal_limit(p, s, e, i)) {
      if (high_variance(p, s, hev)) filter_common(p, s, true);
      else filter_mbedge(p, s);
    }
}

void inner_edge(uint8_t* p, int a, int s, int n, int e, int i, int hev) {
  for (int k = 0; k < n; ++k, p += a)
    if (normal_limit(p, s, e, i)) filter_common(p, s, high_variance(p, s, hev));
}

void simple_edge(uint8_t* p, int a, int s, int e) {
  for (int k = 0; k < 16; ++k, p += a)
    if (simple_limit(p, s, e)) filter_common(p, s, true);
}

// ----------------------------------------------------------- structures

struct Mv {
  int16_t x = 0, y = 0;   // quarter-pel luma: column, row
  bool zero() const { return !x && !y; }
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
};

struct MbInfo {
  uint8_t ymode = kDc, uvmode = kDc, ref = kIntra, segment = 0;
  bool skip = false;          // no coefficients (the loop filter's skip)
  Mv mv;                      // a split MB's: its last sub-block's
  Mv bmv[16];
  uint8_t bmode[16] = {};     // B_PRED sub-modes (keyframe contexts)
};

struct Plane {
  int w = 0, h = 0;           // 16-aligned (8-aligned for chroma)
  std::vector<uint8_t> px;
  uint8_t* at(int x, int y) { return &px[size_t(y) * w + x]; }
  uint8_t get(int x, int y) const {
    return px[size_t(clampi(y, 0, h - 1)) * w + clampi(x, 0, w - 1)];
  }
};

struct Frame {
  Plane p[3];
};

struct Probs {
  uint8_t coef[4][8][3][11];
  uint8_t ymode[4], uvmode[3];
  uint8_t mv[2][19];
};

struct Quant {
  int y[2], y2[2], uv[2];     // DC, AC step of each block kind
};

// Predict a bw x bh block of `ref` at full-pel (x, y) and eighth-pel
// fraction (fx, fy) into dst: §18.3's two passes, horizontal first,
// each rounded and clamped to 8 bits (six-tap, or bilinear).
void predict_inter(const Plane& ref, int x, int y, int fx, int fy, int bw,
                   int bh, bool bilinear, uint8_t* dst, int stride) {
  uint8_t win[21 * 21];
  const int ww = bw + 5, wh = bh + 5;
  for (int r = 0; r < wh; ++r)
    for (int c = 0; c < ww; ++c)
      win[r * ww + c] = ref.get(x - 2 + c, y - 2 + r);
  uint8_t tmp[21 * 16];
  if (!bilinear) {
    const int* h = kSixtap[fx];
    const int* v = kSixtap[fy];
    for (int r = 0; r < wh; ++r)
      for (int c = 0; c < bw; ++c) {
        const uint8_t* s = &win[r * ww + c];
        int t = h[0] * s[0] + h[1] * s[1] + h[2] * s[2] + h[3] * s[3] +
                h[4] * s[4] + h[5] * s[5];
        tmp[r * bw + c] = clip8((t + 64) >> 7);
      }
    for (int r = 0; r < bh; ++r)
      for (int c = 0; c < bw; ++c) {
        const uint8_t* s = &tmp[r * bw + c];
        int t = v[0] * s[0] + v[1] * s[bw] + v[2] * s[2 * bw] +
                v[3] * s[3 * bw] + v[4] * s[4 * bw] + v[5] * s[5 * bw];
        dst[r * stride + c] = clip8((t + 64) >> 7);
      }
    return;
  }
  for (int r = 0; r <= bh; ++r)
    for (int c = 0; c < bw; ++c) {
      const uint8_t* s = &win[(r + 2) * ww + c + 2];
      tmp[r * bw + c] = uint8_t(((8 - fx) * s[0] + fx * s[1] + 4) >> 3);
    }
  for (int r = 0; r < bh; ++r)
    for (int c = 0; c < bw; ++c) {
      const uint8_t* s = &tmp[r * bw + c];
      dst[r * stride + c] = uint8_t(((8 - fy) * s[0] + fy * s[bw] + 4) >> 3);
    }
}

// §12.2: a 16x16 luma or 8x8 chroma predictor at pixel (px, py).
void predict_intra(Plane& pl, int px, int py, int size, int mode) {
  uint8_t* d = pl.at(px, py);
  const int st = pl.w;
  uint8_t above[16], left[16];
  for (int i = 0; i < size; ++i) {
    above[i] = py > 0 ? d[i - st] : 127;
    left[i] = px > 0 ? d[i * st - 1] : 129;
  }
  int corner = py == 0 ? 127 : px == 0 ? 129 : d[-st - 1];
  int shift = size == 16 ? 4 : 3;
  for (int r = 0; r < size; ++r)
    for (int c = 0; c < size; ++c) {
      int v;
      switch (mode) {
        case kV: v = above[c]; break;
        case kH: v = left[r]; break;
        case kTm: v = clip8(left[r] + above[c] - corner); break;
        default: {
          int sum = 0;
          if (py > 0)
            for (int i = 0; i < size; ++i) sum += above[i];
          if (px > 0)
            for (int i = 0; i < size; ++i) sum += left[i];
          if (py > 0 && px > 0) v = (sum + size) >> (shift + 1);
          else if (py > 0 || px > 0) v = (sum + size / 2) >> shift;
          else v = 128;
        }
      }
      d[r * st + c] = uint8_t(v);
    }
}

inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}

// §12.3: a 4x4 sub-block predictor from its above row A (8 pixels, the
// last 4 above-right), left column L and corner P.
void predict_sub(uint8_t* d, int st, int mode, const uint8_t* A,
                 const uint8_t* L, int P) {
  uint8_t B[4][4];
  const int E[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
  switch (mode) {
    case kBDc: {
      int v = 4;
      for (int i = 0; i < 4; ++i) v += A[i] + L[i];
      std::memset(B, v >> 3, sizeof(B));
      break;
    }
    case kBTm:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) B[r][c] = clip8(L[r] + A[c] - P);
      break;
    case kBVe:
      for (int c = 0; c < 4; ++c) {
        uint8_t v = avg3(c ? A[c - 1] : P, A[c], A[c + 1]);
        for (int r = 0; r < 4; ++r) B[r][c] = v;
      }
      break;
    case kBHe:
      for (int r = 0; r < 4; ++r) {
        uint8_t v = avg3(r ? L[r - 1] : P, L[r], L[r < 3 ? r + 1 : 3]);
        for (int c = 0; c < 4; ++c) B[r][c] = v;
      }
      break;
    case kBLd:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          int i = r + c;
          B[r][c] = i < 6 ? avg3(A[i], A[i + 1], A[i + 2])
                          : avg3(A[6], A[7], A[7]);
        }
      break;
    case kBRd:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
          int i = 3 - r + c;
          B[r][c] = avg3(E[i], E[i + 1], E[i + 2]);
        }
      break;
    case kBVr:
      B[3][0] = avg3(E[1], E[2], E[3]);
      B[2][0] = avg3(E[2], E[3], E[4]);
      B[3][1] = B[1][0] = avg3(E[3], E[4], E[5]);
      B[2][1] = B[0][0] = avg2(E[4], E[5]);
      B[3][2] = B[1][1] = avg3(E[4], E[5], E[6]);
      B[2][2] = B[0][1] = avg2(E[5], E[6]);
      B[3][3] = B[1][2] = avg3(E[5], E[6], E[7]);
      B[2][3] = B[0][2] = avg2(E[6], E[7]);
      B[1][3] = avg3(E[6], E[7], E[8]);
      B[0][3] = avg2(E[7], E[8]);
      break;
    case kBVl:
      B[0][0] = avg2(A[0], A[1]);
      B[1][0] = avg3(A[0], A[1], A[2]);
      B[2][0] = B[0][1] = avg2(A[1], A[2]);
      B[1][1] = B[3][0] = avg3(A[1], A[2], A[3]);
      B[2][1] = B[0][2] = avg2(A[2], A[3]);
      B[3][1] = B[1][2] = avg3(A[2], A[3], A[4]);
      B[2][2] = B[0][3] = avg2(A[3], A[4]);
      B[3][2] = B[1][3] = avg3(A[3], A[4], A[5]);
      B[2][3] = avg3(A[4], A[5], A[6]);
      B[3][3] = avg3(A[5], A[6], A[7]);
      break;
    case kBHd:
      B[3][0] = avg2(E[0], E[1]);
      B[3][1] = avg3(E[0], E[1], E[2]);
      B[2][0] = B[3][2] = avg2(E[1], E[2]);
      B[2][1] = B[3][3] = avg3(E[1], E[2], E[3]);
      B[2][2] = B[1][0] = avg2(E[2], E[3]);
      B[2][3] = B[1][1] = avg3(E[2], E[3], E[4]);
      B[1][2] = B[0][0] = avg2(E[3], E[4]);
      B[1][3] = B[0][1] = avg3(E[3], E[4], E[5]);
      B[0][2] = avg3(E[4], E[5], E[6]);
      B[0][3] = avg3(E[5], E[6], E[7]);
      break;
    default:  // kBHu
      B[0][0] = avg2(L[0], L[1]);
      B[0][1] = avg3(L[0], L[1], L[2]);
      B[0][2] = B[1][0] = avg2(L[1], L[2]);
      B[0][3] = B[1][1] = avg3(L[1], L[2], L[3]);
      B[1][2] = B[2][0] = avg2(L[2], L[3]);
      B[1][3] = B[2][1] = avg3(L[2], L[3], L[3]);
      B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] = L[3];
      break;
  }
  for (int r = 0; r < 4; ++r) std::memcpy(d + r * st, B[r], 4);
}

}  // namespace

// ================================================================ decoder

struct Vp8Decoder::State {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  std::shared_ptr<Frame> ref[4];          // [kLast], [kGolden], [kAltref]
  Probs probs, saved;
  bool sign_bias[4] = {};
  // Segmentation and loop-filter deltas persist from frame to frame.
  bool seg_enabled = false, seg_update_map = false;
  int seg_q[4] = {}, seg_lf[4] = {};
  uint8_t seg_prob[3] = {255, 255, 255};
  std::vector<uint8_t> seg_map;
  bool lf_delta = false;
  int ref_delta[4] = {}, mode_delta[4] = {};
  // This frame's header.
  bool key = false, show = false;
  int version = 0;
  int filter_simple = 0, filter_level = 0, sharpness = 0;
  int nparts = 1;
  Quant quant[4];
  int prob_skip = 0, prob_intra = 0, prob_last = 0, prob_gf = 0;
  bool refresh_golden = false, refresh_alt = false, refresh_last = false,
       refresh_probs = false;
  int copy_alt = 0;
  BoolDecoder hdr, parts[8];
  // Decoding.
  std::shared_ptr<Frame> cur;
  std::vector<MbInfo> mbs;
  std::vector<uint8_t> above_nz;          // 9 a macroblock column
  uint8_t left_nz[9];
  int16_t coef[25][16];
  MbInfo outside;                         // beyond the picture's edges

  State() { reset_probs(); }

  void reset_probs() {
    std::memcpy(probs.coef, kCoefDefault, sizeof(probs.coef));
    std::memcpy(probs.ymode, kYmodeProb, sizeof(probs.ymode));
    std::memcpy(probs.uvmode, kUvModeProb, sizeof(probs.uvmode));
    std::memcpy(probs.mv, kMvDefault, sizeof(probs.mv));
  }

  std::shared_ptr<Frame> new_frame() const {
    auto f = std::make_shared<Frame>();
    int dims[3][2] = {{mbw * 16, mbh * 16}, {mbw * 8, mbh * 8},
                      {mbw * 8, mbh * 8}};
    for (int i = 0; i < 3; ++i) {
      f->p[i].w = dims[i][0];
      f->p[i].h = dims[i][1];
      f->p[i].px.assign(size_t(dims[i][0]) * dims[i][1], 0);
    }
    return f;
  }

  void header(const uint8_t* d, size_t n);
  void modes(MbInfo& m, int mx, int my);
  Mv read_mv();
  int read_mv_component(const uint8_t* p);
  void split_mvs(MbInfo& m, const MbInfo& left, const MbInfo& above,
                 Mv best);
  int block_tokens(BoolDecoder& b, int16_t* out, int type, int first,
                   int ctx, const int* dq);
  void residual(MbInfo& m, int mx, BoolDecoder& b);
  void reconstruct(const MbInfo& m, int mx, int my);
  void loop_filter();
  bool decode(const uint8_t* d, size_t n, Picture& out);
};

void Vp8Decoder::State::header(const uint8_t* d, size_t n) {
  uint32_t tag = d[0] | (uint32_t(d[1]) << 8) | (uint32_t(d[2]) << 16);
  key = !(tag & 1);
  version = (tag >> 1) & 7;
  show = (tag >> 4) & 1;
  size_t first = tag >> 5;
  if (version > 3)
    unsupported("VP8 version " + std::to_string(version) +
                " (RFC 6386 defines 0-3)");
  size_t off = 3;
  if (key) {
    if (n < 10) broken("VP8 keyframe header cut short");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
      broken("VP8 keyframe without its start code");
    int w = (d[6] | (d[7] << 8)) & 0x3fff, h = (d[8] | (d[9] << 8)) & 0x3fff;
    if (!w || !h) broken("VP8 keyframe of size 0");
    if (w != width || h != height) {
      width = w;
      height = h;
      mbw = (w + 15) / 16;
      mbh = (h + 15) / 16;
      ref[kLast] = ref[kGolden] = ref[kAltref] = nullptr;
      seg_map.assign(size_t(mbw) * mbh, 0);
    }
    off = 10;
  } else if (!ref[kLast]) {
    broken("VP8 inter frame before the first keyframe");
  }
  if (off + first > n) broken("VP8 first partition runs past the frame");
  BoolDecoder& b = hdr;
  b.init(d + off, first);
  if (key) {
    reset_probs();
    sign_bias[kGolden] = sign_bias[kAltref] = false;
    seg_enabled = false;
    std::memset(seg_q, 0, sizeof(seg_q));
    std::memset(seg_lf, 0, sizeof(seg_lf));
    lf_delta = false;
    std::memset(ref_delta, 0, sizeof(ref_delta));
    std::memset(mode_delta, 0, sizeof(mode_delta));
    if (b.bit()) unsupported("VP8 colour space 1 (reserved)");
    if (b.bit()) unsupported("VP8 clamping type 1 (no clamping)");
  }
  seg_enabled = b.bit();
  seg_update_map = false;
  if (seg_enabled) {
    seg_update_map = b.bit();
    bool update_data = b.bit();
    if (update_data) {
      if (b.bit()) unsupported("VP8 segment data in absolute values");
      for (int i = 0; i < 4; ++i) seg_q[i] = b.delta(7);
      for (int i = 0; i < 4; ++i) seg_lf[i] = b.delta(6);
    }
    if (seg_update_map)
      for (int i = 0; i < 3; ++i) seg_prob[i] = b.bit() ? b.literal(8) : 255;
    // libvpx resets the map of such a keyframe to segment 0, ffmpeg keeps
    // the previous frame's.
    if (key && !seg_update_map)
      unsupported("VP8 keyframe with segmentation that keeps an earlier "
                  "frame's segment map");
  }
  filter_simple = b.bit();
  filter_level = b.literal(6);
  sharpness = b.literal(3);
  lf_delta = b.bit();
  if (lf_delta && b.bit()) {
    for (int i = 0; i < 4; ++i)
      if (b.bit()) {
        int v = b.literal(6);
        ref_delta[i] = b.bit() ? -v : v;
      }
    for (int i = 0; i < 4; ++i)
      if (b.bit()) {
        int v = b.literal(6);
        mode_delta[i] = b.bit() ? -v : v;
      }
  }
  nparts = 1 << b.literal(2);
  int yac = b.literal(7);
  int ydc = b.delta(4), y2dc = b.delta(4), y2ac = b.delta(4);
  int uvdc = b.delta(4), uvac = b.delta(4);
  for (int s = 0; s < 4; ++s) {
    int q = seg_enabled ? yac + seg_q[s] : yac;
    auto at = [](int i) { return clampi(i, 0, 127); };
    Quant& qt = quant[s];
    qt.y[0] = kDcQ[at(q + ydc)];
    qt.y[1] = kAcQ[at(q)];
    qt.y2[0] = kDcQ[at(q + y2dc)] * 2;
    qt.y2[1] = std::max(kAcQ[at(q + y2ac)] * 155 / 100, 8);
    qt.uv[0] = std::min<int>(kDcQ[at(q + uvdc)], 132);
    qt.uv[1] = kAcQ[at(q + uvac)];
  }
  if (key) {
    refresh_golden = refresh_alt = refresh_last = true;
    copy_alt = 0;
    refresh_probs = b.bit();
  } else {
    refresh_golden = b.bit();
    refresh_alt = b.bit();
    int copy_golden = refresh_golden ? 0 : b.literal(2);
    copy_alt = refresh_alt ? 0 : b.literal(2);
    sign_bias[kGolden] = b.bit();
    sign_bias[kAltref] = b.bit();
    if (copy_golden)
      unsupported("VP8 golden frame copied from another reference "
                  "(copy_buffer_to_golden " + std::to_string(copy_golden) +
                  ")");
    if (copy_alt & 1)
      unsupported("VP8 altref frame copied from the last frame "
                  "(copy_buffer_to_alternate " + std::to_string(copy_alt) +
                  ")");
    if (sign_bias[kGolden]) unsupported("VP8 sign bias on the golden frame");
    refresh_probs = b.bit();
    refresh_last = b.bit();
  }
  if (!refresh_probs) saved = probs;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 11; ++l)
          if (b.get(kCoefUpdate[i][j][k][l]))
            probs.coef[i][j][k][l] = uint8_t(b.literal(8));
  if (!b.bit())
    unsupported("VP8 without mb_no_coeff_skip (no macroblock skip flags)");
  prob_skip = b.literal(8);
  if (!key) {
    prob_intra = b.literal(8);
    prob_last = b.literal(8);
    prob_gf = b.literal(8);
    if (b.bit())
      for (int i = 0; i < 4; ++i) probs.ymode[i] = uint8_t(b.literal(8));
    if (b.bit())
      for (int i = 0; i < 3; ++i) probs.uvmode[i] = uint8_t(b.literal(8));
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 19; ++j)
        if (b.get(kMvUpdate[i][j])) {
          int v = b.literal(7);
          probs.mv[i][j] = uint8_t(v ? v << 1 : 1);
        }
  }
  // The token partitions follow the first one, after their sizes.
  const uint8_t* p = d + off + first;
  const uint8_t* end = d + n;
  if (size_t(end - p) < size_t(3 * (nparts - 1)))
    broken("VP8 partition sizes cut short");
  const uint8_t* q = p + 3 * (nparts - 1);
  for (int i = 0; i < nparts; ++i) {
    size_t sz = size_t(end - q);
    if (i < nparts - 1) {
      sz = p[3 * i] | (size_t(p[3 * i + 1]) << 8) |
           (size_t(p[3 * i + 2]) << 16);
      if (sz > size_t(end - q))
        broken("VP8 token partition runs past the frame");
    }
    parts[i].init(q, sz);
    q += sz;
  }
}

int Vp8Decoder::State::read_mv_component(const uint8_t* p) {
  BoolDecoder& b = hdr;
  int v = 0;
  if (b.get(p[0])) {
    for (int i = 0; i < 3; ++i) v += b.get(p[9 + i]) << i;
    for (int i = 9; i > 3; --i) v += b.get(p[9 + i]) << i;
    if (!(v & 0xFFF0) || b.get(p[9 + 3])) v += 8;
  } else {
    v = b.tree(kSmallMvTree, p + 2);
  }
  return v && b.get(p[1]) ? -v : v;
}

Mv Vp8Decoder::State::read_mv() {
  Mv m;
  m.y = int16_t(read_mv_component(probs.mv[0]));
  m.x = int16_t(read_mv_component(probs.mv[1]));
  return m;
}

void Vp8Decoder::State::split_mvs(MbInfo& m, const MbInfo& left,
                                  const MbInfo& above, Mv best) {
  BoolDecoder& b = hdr;
  int part = b.get(kMbSplitProb[0])
                 ? (b.get(kMbSplitProb[1]) ? b.get(kMbSplitProb[2]) : 2)
                 : 3;
  const uint8_t* map = kMbSplits[part];
  Mv pmv[16];
  for (int n = 0, k = 0; n < kMbSplitCount[part]; ++n) {
    while (map[k] != n) ++k;          // the partition's first sub-block
    Mv l = (k & 3) ? pmv[map[k - 1]] : left.bmv[k + 3];
    Mv a = k >= 4 ? pmv[map[k - 4]] : above.bmv[k + 12];
    int ctx = l == a ? (a.zero() ? 4 : 3) : a.zero() ? 2 : l.zero() ? 1 : 0;
    const uint8_t* p = kSubMvRefProb[ctx];
    Mv v;
    if (!b.get(p[0])) {
      v = l;
    } else if (!b.get(p[1])) {
      v = a;
    } else if (b.get(p[2])) {
      Mv d = read_mv();
      v.x = int16_t(best.x + d.x);
      v.y = int16_t(best.y + d.y);
    }
    pmv[n] = v;
  }
  for (int k = 0; k < 16; ++k) m.bmv[k] = pmv[map[k]];
  m.mv = m.bmv[15];
}

void Vp8Decoder::State::modes(MbInfo& m, int mx, int my) {
  BoolDecoder& b = hdr;
  // The map: read, or the previous frame's kept, or 0 while disabled.
  uint8_t& seg = seg_map[size_t(my) * mbw + mx];
  if (seg_update_map) seg = uint8_t(b.tree(kSegmentTree, seg_prob));
  else if (!seg_enabled) seg = 0;
  m.segment = seg;
  m.skip = b.get(prob_skip);
  const MbInfo& above = my > 0 ? mbs[size_t(my - 1) * mbw + mx] : outside;
  const MbInfo& left = mx > 0 ? mbs[size_t(my) * mbw + mx - 1] : outside;
  if (key || !b.get(prob_intra)) {
    m.ref = kIntra;
    m.mv = Mv();
    for (Mv& v : m.bmv) v = Mv();
    if (key) {
      m.ymode = uint8_t(b.tree(kKfYmodeTree, kKfYmodeProb));
      if (m.ymode == kB) {
        for (int i = 0; i < 16; ++i) {
          int a = i >= 4 ? m.bmode[i - 4] : above.bmode[i + 12];
          int l = (i & 3) ? m.bmode[i - 1] : left.bmode[i + 3];
          m.bmode[i] = uint8_t(b.tree(kBmodeTree, kKfBmodeProb[a][l]));
        }
      }
      m.uvmode = uint8_t(b.tree(kUvModeTree, kKfUvModeProb));
    } else {
      m.ymode = uint8_t(b.tree(kYmodeTree, probs.ymode));
      if (m.ymode == kB)
        for (int i = 0; i < 16; ++i)
          m.bmode[i] = uint8_t(b.tree(kBmodeTree, kBmodeProb));
      m.uvmode = uint8_t(b.tree(kUvModeTree, probs.uvmode));
    }
    if (m.ymode != kB) {
      static const uint8_t kImplied[4] = {kBDc, kBVe, kBHe, kBTm};
      std::memset(m.bmode, kImplied[m.ymode], sizeof(m.bmode));
    }
    return;
  }
  m.ref = b.get(prob_last) ? (b.get(prob_gf) ? kAltref : kGolden) : kLast;
  m.uvmode = kDc;
  std::memset(m.bmode, kBDc, sizeof(m.bmode));
  // §16.3: the near and nearest MVs of the above, left and above-left
  // macroblocks, with the counts that pick the mode probabilities.
  const MbInfo& aboveleft =
      my > 0 && mx > 0 ? mbs[size_t(my - 1) * mbw + mx - 1] : outside;
  const MbInfo* edge[3] = {&above, &left, &aboveleft};
  Mv near[4];
  int cnt[4] = {0, 0, 0, 0};
  int idx = 0;
  for (int e = 0; e < 3; ++e) {
    const MbInfo& o = *edge[e];
    if (o.ref == kIntra) continue;
    int weight = e == 2 ? 1 : 2;
    if (o.mv.zero()) {
      cnt[0] += weight;
      continue;
    }
    Mv v = o.mv;
    if (sign_bias[o.ref] != sign_bias[m.ref]) {
      v.x = int16_t(-v.x);
      v.y = int16_t(-v.y);
    }
    if (e == 0 || !(v == near[idx])) near[++idx] = v;
    cnt[idx] += weight;
  }
  auto clamp = [&](Mv v) {
    v.x = int16_t(clampi(v.x, -mx * 64 - 64, (mbw - 1 - mx) * 64 + 64));
    v.y = int16_t(clampi(v.y, -my * 64 - 64, (mbh - 1 - my) * 64 + 64));
    return v;
  };
  if (!b.get(kModeContexts[cnt[0]][0])) {
    m.ymode = kZero;
    m.mv = Mv();
  } else {
    if (cnt[3] && near[1] == near[3]) cnt[1] += 1;
    if (cnt[2] > cnt[1]) {
      std::swap(cnt[1], cnt[2]);
      std::swap(near[1], near[2]);
    }
    if (!b.get(kModeContexts[cnt[1]][1])) {
      m.ymode = kNearest;
      m.mv = clamp(near[1]);
    } else if (!b.get(kModeContexts[cnt[2]][2])) {
      m.ymode = kNear;
      m.mv = clamp(near[2]);
    } else {
      Mv best = clamp(near[cnt[1] >= cnt[0] ? 1 : 0]);
      int splits = (above.ymode == kSplit) * 2 + (left.ymode == kSplit) * 2 +
                   (aboveleft.ymode == kSplit);
      if (b.get(kModeContexts[splits][3])) {
        m.ymode = kSplit;
        split_mvs(m, left, above, best);
        return;
      }
      m.ymode = kNew;
      Mv dv = read_mv();
      m.mv.x = int16_t(best.x + dv.x);
      m.mv.y = int16_t(best.y + dv.y);
    }
  }
  for (Mv& v : m.bmv) v = m.mv;
}

// §13: one block's tokens, dequantised into `out` (natural order). →
// the index past its last token, 0 when it holds none.
int Vp8Decoder::State::block_tokens(BoolDecoder& b, int16_t* out, int type,
                                    int first, int ctx, const int* dq) {
  const uint8_t(*pr)[3][11] = probs.coef[type];
  int i = first;
  const uint8_t* p = pr[kBands[i]][ctx];
  if (!b.get(p[0])) return 0;
  while (true) {
    if (!b.get(p[1])) {                           // DCT_0
      if (++i == 16) return 16;
      p = pr[kBands[i]][0];
      continue;                                   // no EOB after a zero
    }
    int v, next;
    if (!b.get(p[2])) {
      v = 1;
      next = 1;
    } else {
      if (!b.get(p[3])) {
        v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
      } else if (!b.get(p[6])) {
        v = !b.get(p[7]) ? 5 + b.get(159)
                         : 7 + 2 * b.get(165) + b.get(145);
      } else {
        int hi = b.get(p[8]);
        int cat = 2 * hi + b.get(p[9 + hi]);
        int extra = 0;
        for (const uint8_t* c = kCatProb[cat]; *c; ++c)
          extra = (extra << 1) | b.get(*c);
        v = kCatBase[cat] + extra;
      }
      next = 2;
    }
    if (b.bit()) v = -v;
    out[kZigzag[i]] = int16_t(v * dq[i > 0]);
    if (++i == 16) return 16;
    p = pr[kBands[i]][next];
    if (!b.get(p[0])) return i;                   // EOB
  }
}

void Vp8Decoder::State::residual(MbInfo& m, int mx, BoolDecoder& b) {
  std::memset(coef, 0, sizeof(coef));
  uint8_t* an = &above_nz[size_t(mx) * 9];
  uint8_t* ln = left_nz;
  bool y2 = m.ymode != kB && m.ymode != kSplit;
  if (m.skip) {
    std::memset(an, 0, 8);
    std::memset(ln, 0, 8);
    if (y2) an[8] = ln[8] = 0;
    return;
  }
  const Quant& q = quant[m.segment];
  int total = 0, first = 0, ytype = 3;
  if (y2) {
    int n = block_tokens(b, coef[24], 1, 0, an[8] + ln[8], q.y2);
    an[8] = ln[8] = n > 0;
    total += n;
    int16_t dc[16][16];
    inverse_wht(coef[24], dc);
    for (int i = 0; i < 16; ++i) coef[i][0] = dc[i][0];
    first = 1;
    ytype = 0;
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int n = block_tokens(b, coef[4 * y + x], ytype, first, an[x] + ln[y],
                           q.y);
      an[x] = ln[y] = n > 0;
      total += n;
    }
  for (int c = 0; c < 2; ++c)
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        int n = block_tokens(b, coef[16 + 4 * c + 2 * y + x], 2, 0,
                             an[4 + 2 * c + x] + ln[4 + 2 * c + y], q.uv);
        an[4 + 2 * c + x] = ln[4 + 2 * c + y] = n > 0;
        total += n;
      }
  if (!total) m.skip = true;
}

void Vp8Decoder::State::reconstruct(const MbInfo& m, int mx, int my) {
  Plane& Y = cur->p[0];
  const int X0 = mx * 16, Y0 = my * 16;
  if (m.ref == kIntra) {
    if (m.ymode == kB) {
      for (int i = 0; i < 16; ++i) {
        int bx = i & 3, by = i >> 2, X = X0 + 4 * bx, Yp = Y0 + 4 * by;
        uint8_t* d = Y.at(X, Yp);
        uint8_t A[8], L[4];
        for (int k = 0; k < 4; ++k) {
          A[k] = Yp > 0 ? d[k - Y.w] : 127;
          L[k] = X > 0 ? d[k * Y.w - 1] : 129;
        }
        int row = bx == 3 ? Y0 - 1 : Yp - 1;   // above-right's row
        for (int k = 0; k < 4; ++k)
          A[4 + k] = row < 0 ? 127 : *Y.at(std::min(X + 4 + k, Y.w - 1), row);
        int P = Yp == 0 ? 127 : X == 0 ? 129 : d[-Y.w - 1];
        predict_sub(d, Y.w, m.bmode[i], A, L, P);
        if (any_coef(coef[i])) idct_add4(coef[i], d, Y.w);
      }
    } else {
      predict_intra(Y, X0, Y0, 16, m.ymode);
    }
    predict_intra(cur->p[1], X0 / 2, Y0 / 2, 8, m.uvmode);
    predict_intra(cur->p[2], X0 / 2, Y0 / 2, 8, m.uvmode);
  } else {
    const Frame& r = *ref[m.ref];
    const bool bil = version != 0;
    if (m.ymode != kSplit) {
      Mv v = m.mv;
      predict_inter(r.p[0], X0 + (v.x >> 2), Y0 + (v.y >> 2), (v.x & 3) * 2,
                    (v.y & 3) * 2, 16, 16, bil, Y.at(X0, Y0), Y.w);
      int ux = v.x, uy = v.y;                 // eighth-pel chroma
      if (version == 3) {
        ux &= ~7;
        uy &= ~7;
      }
      for (int c = 1; c < 3; ++c)
        predict_inter(r.p[c], X0 / 2 + (ux >> 3), Y0 / 2 + (uy >> 3), ux & 7,
                      uy & 7, 8, 8, bil, cur->p[c].at(X0 / 2, Y0 / 2),
                      cur->p[c].w);
    } else {
      for (int i = 0; i < 16; ++i) {
        Mv v = m.bmv[i];
        int X = X0 + 4 * (i & 3), Yp = Y0 + 4 * (i >> 2);
        predict_inter(r.p[0], X + (v.x >> 2), Yp + (v.y >> 2), (v.x & 3) * 2,
                      (v.y & 3) * 2, 4, 4, bil, Y.at(X, Yp), Y.w);
      }
      // Each chroma 4x4 block: the mean of its four luma MVs, rounded
      // half away from zero, in eighth-pel chroma.
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          int k = 8 * by + 2 * bx;
          int sx = m.bmv[k].x + m.bmv[k + 1].x + m.bmv[k + 4].x +
                   m.bmv[k + 5].x;
          int sy = m.bmv[k].y + m.bmv[k + 1].y + m.bmv[k + 4].y +
                   m.bmv[k + 5].y;
          int ux = (sx + 2 + (sx >> 31)) >> 2, uy = (sy + 2 + (sy >> 31)) >> 2;
          if (version == 3) {
            ux &= ~7;
            uy &= ~7;
          }
          int X = X0 / 2 + 4 * bx, Yp = Y0 / 2 + 4 * by;
          for (int c = 1; c < 3; ++c)
            predict_inter(r.p[c], X + (ux >> 3), Yp + (uy >> 3), ux & 7,
                          uy & 7, 4, 4, bil, cur->p[c].at(X, Yp), cur->p[c].w);
        }
    }
  }
  if (m.ref != kIntra || m.ymode != kB)
    for (int i = 0; i < 16; ++i)
      if (any_coef(coef[i]))
        idct_add4(coef[i], Y.at(X0 + 4 * (i & 3), Y0 + 4 * (i >> 2)), Y.w);
  for (int i = 16; i < 24; ++i) {
    Plane& C = cur->p[i < 20 ? 1 : 2];
    int k = (i - 16) & 3;
    if (any_coef(coef[i]))
      idct_add4(coef[i], C.at(X0 / 2 + 4 * (k & 1), Y0 / 2 + 4 * (k >> 1)),
                C.w);
  }
}

void Vp8Decoder::State::loop_filter() {
  if (!filter_level) return;
  Plane &Y = cur->p[0], &U = cur->p[1], &V = cur->p[2];
  for (int my = 0; my < mbh; ++my)
    for (int mx = 0; mx < mbw; ++mx) {
      const MbInfo& m = mbs[size_t(my) * mbw + mx];
      int level = filter_level + (seg_enabled ? seg_lf[m.segment] : 0);
      if (lf_delta) {
        level += ref_delta[m.ref];
        if (m.ymode == kB) level += mode_delta[0];
        else if (m.ymode == kZero) level += mode_delta[1];
        else if (m.ymode == kSplit) level += mode_delta[3];
        else if (m.ref != kIntra) level += mode_delta[2];
      }
      level = clampi(level, 0, 63);
      if (!level) continue;
      int interior = level;
      if (sharpness) {
        interior >>= (sharpness + 3) >> 2;
        interior = std::min(interior, 9 - sharpness);
      }
      interior = std::max(interior, 1);
      int hev = level >= 40 ? (key ? 2 : 3)
                : level >= 20 ? (key ? 1 : 2)
                : level >= 15 ? 1
                              : 0;
      bool inner = !m.skip || m.ymode == kB || m.ymode == kSplit;
      int be = 2 * level + interior, mbe = be + 4;
      uint8_t* y = Y.at(mx * 16, my * 16);
      if (filter_simple) {
        if (mx) simple_edge(y, Y.w, 1, mbe);
        if (inner)
          for (int x = 4; x < 16; x += 4) simple_edge(y + x, Y.w, 1, be);
        if (my) simple_edge(y, 1, Y.w, mbe);
        if (inner)
          for (int r = 4; r < 16; r += 4) simple_edge(y + r * Y.w, 1, Y.w, be);
        continue;
      }
      uint8_t* u = U.at(mx * 8, my * 8);
      uint8_t* v = V.at(mx * 8, my * 8);
      const int cw = U.w;
      if (mx) {
        mb_edge(y, Y.w, 1, 16, mbe, interior, hev);
        mb_edge(u, cw, 1, 8, mbe, interior, hev);
        mb_edge(v, cw, 1, 8, mbe, interior, hev);
      }
      if (inner) {
        for (int x = 4; x < 16; x += 4)
          inner_edge(y + x, Y.w, 1, 16, be, interior, hev);
        inner_edge(u + 4, cw, 1, 8, be, interior, hev);
        inner_edge(v + 4, cw, 1, 8, be, interior, hev);
      }
      if (my) {
        mb_edge(y, 1, Y.w, 16, mbe, interior, hev);
        mb_edge(u, 1, cw, 8, mbe, interior, hev);
        mb_edge(v, 1, cw, 8, mbe, interior, hev);
      }
      if (inner) {
        for (int r = 4; r < 16; r += 4)
          inner_edge(y + r * Y.w, 1, Y.w, 16, be, interior, hev);
        inner_edge(u + 4 * cw, 1, cw, 8, be, interior, hev);
        inner_edge(v + 4 * cw, 1, cw, 8, be, interior, hev);
      }
    }
}

bool Vp8Decoder::State::decode(const uint8_t* d, size_t n, Picture& out) {
  if (n < 3) broken("VP8 frame shorter than its frame tag");
  header(d, n);
  cur = new_frame();
  mbs.assign(size_t(mbw) * mbh, MbInfo());
  above_nz.assign(size_t(mbw) * 9, 0);
  for (int my = 0; my < mbh; ++my) {
    std::memset(left_nz, 0, sizeof(left_nz));
    BoolDecoder& tokens = parts[my & (nparts - 1)];
    for (int mx = 0; mx < mbw; ++mx) {
      MbInfo& m = mbs[size_t(my) * mbw + mx];
      modes(m, mx, my);
      residual(m, mx, tokens);
      reconstruct(m, mx, my);
    }
  }
  loop_filter();
  if (!refresh_probs) probs = saved;
  // §9.7: the copy (the old golden to altref; header() refuses the
  // others), then the refreshes with this frame.
  if (copy_alt == 2) ref[kAltref] = ref[kGolden];
  if (refresh_golden) ref[kGolden] = cur;
  if (refresh_alt) ref[kAltref] = cur;
  if (refresh_last) ref[kLast] = cur;
  if (!show) return false;
  out.w = width;
  out.h = height;
  out.ystride = cur->p[0].w;
  out.cstride = cur->p[1].w;
  out.y = cur->p[0].px;
  out.u = cur->p[1].px;
  out.v = cur->p[2].px;
  out.full_range = false;
  return true;
}

Vp8Decoder::Vp8Decoder() : s_(new State) {}

Vp8Decoder::~Vp8Decoder() = default;

bool Vp8Decoder::decode(const uint8_t* data, size_t n, Picture& out) {
  return s_->decode(data, n, out);
}

int Vp8Decoder::peek(const uint8_t* data, size_t n) {
  if (n < 3) broken("VP8 frame shorter than its frame tag");
  if (!((data[0] >> 4) & 1)) return -1;
  return data[0] & 1;
}

}  // namespace viai_video
