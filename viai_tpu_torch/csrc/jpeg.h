// The JPEG entropy decoder of imagedec.cpp, as videodec.cpp's MJPEG
// decoder uses it: the markers, the Huffman scans and the quantization
// tables, without imagedec's libjpeg-style IDCT, upsampling and colour
// conversion.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace viai_jpeg {

struct Error {
  int code;             // 1 broken, 2 unsupported
  std::string msg;
};

struct Plane {
  int h = 1, v = 1;         // sampling factors
  int dw = 0, dh = 0;       // samples
  int bw = 0;               // blocks a row in `coef` (whole MCUs)
  int cbw = 0, cbh = 0;     // blocks that hold samples
  int32_t q[64];            // quantization table, natural order
  std::vector<int16_t> coef;  // block (by, bx) at (by·bw + bx)·64, natural
};

struct Coefficients {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  Plane comp[4];
};

// JPEG bytes → quantized coefficients; `standard_tables` starts from
// annex K's Huffman tables (as ffmpeg does) instead of none. Throws
// Error.
Coefficients decode_coefficients(const uint8_t* data, size_t n,
                                 bool standard_tables);

}  // namespace viai_jpeg
