// PNG row unfiltering on the host (PNG specification, section 9).
//
// A PNG image's inflated data is one filter-type byte and `rowbytes` bytes
// per row. Types 0-2 (None, Sub, Up) are cheap in numpy; Average (3) and
// Paeth (4) read the byte just reconstructed to their left, a recurrence
// along the row, so a Python loop would take seconds at 1920x1080. Built
// into the port's host library beside native/soccdpt_native.cpp and bound
// with ctypes by soccdpt_torch/native.py, which keeps the plain numpy
// version of this function.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src:  height * (1 + rowbytes) bytes, each row led by its filter type
// dst:  height * rowbytes bytes
// bpp:  bytes per complete pixel, at least 1
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int64_t png_unfilter(const uint8_t* src, int64_t height, int64_t rowbytes,
                     int32_t bpp, uint8_t* dst) {
  const uint8_t* prev = nullptr;  // the row above, reconstructed; none for row 0
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t type = src[y * (rowbytes + 1)];
    const uint8_t* in = src + y * (rowbytes + 1) + 1;
    uint8_t* out = dst + y * rowbytes;
    switch (type) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
