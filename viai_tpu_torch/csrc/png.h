// The PNG reader of imagedec.cpp (chunks, inflate, row filters, Adam7),
// as videodec.cpp's PNG video decoder uses it: the image's samples as the
// file holds them, without imagedec's conversion to Pillow's RGB.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace viai_png {

struct Error {
  int code;             // 1 broken, 2 unsupported
  std::string msg;
};

struct Image {
  int w = 0, h = 0, depth = 0, ctype = 0;
  bool interlaced = false;
  int npal = -1;                    // PLTE entries, −1 without one
  uint8_t pal[256 * 3] = {};
  std::vector<uint8_t> trns;        // the tRNS chunk's bytes
  int64_t rowbytes = 0;
  // h rows of rowbytes: the samples as the file packs them (big-endian,
  // depths below 8 from each byte's top bit), de-interlaced.
  std::vector<uint8_t> rows;
};

// PNG bytes (the signature included) → the image; `check_crc`: refuse a
// chunk whose CRC does not match. Throws Error.
Image parse(const uint8_t* data, size_t n, bool check_crc);

}  // namespace viai_png
