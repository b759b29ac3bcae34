// PNG row unfiltering for dynmm_tpu_torch/data/png.py.
//
// The prepared RGB-D layouts hold PNGs that OpenCV wrote with adaptive
// filters, so every row may use any of the five filter types. Sub, Average
// and Paeth read the byte one pixel to the left, which makes the loop
// serial along a row: in numpy it costs ~0.3 s per 480x640 image, here a
// few milliseconds. zlib inflation stays in Python (the zlib module).
//
// src: height rows of (1 filter byte + rowbytes bytes), as inflated.
// dst: height * rowbytes unfiltered bytes. bpp: bytes per complete pixel
// (rounded up to 1). Returns 0, or 1 + the index of the first row whose
// filter byte is not 0..4.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

int png_unfilter(const uint8_t* src, int height, int rowbytes, int bpp,
                 uint8_t* dst) {
  std::vector<uint8_t> zero(static_cast<size_t>(rowbytes), 0);
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = src + static_cast<int64_t>(y) * (rowbytes + 1);
    const int filter = in[0];
    ++in;
    uint8_t* out = dst + static_cast<int64_t>(y) * rowbytes;
    const uint8_t* up = y ? out - rowbytes : zero.data();
    switch (filter) {
      case 0:  // None
        std::memcpy(out, in, rowbytes);
        break;
      case 1:  // Sub
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:  // Average
        for (int i = 0; i < rowbytes; ++i) {
          const int left = i >= bpp ? out[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((left + up[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up[i];
          const int c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
