// PNG scanline unfiltering (PNG spec section 9): the one part of decoding a
// PNG that cannot be vectorised, because the Sub, Average and Paeth filters
// read the pixel to the left, already unfiltered. Plain C interface, loaded
// with ctypes by genpose2_tpu_torch/data/png.py.
//
// in:  h rows of (1 + stride) bytes, the filter type byte then the filtered row
// out: h rows of stride bytes
// bpp: bytes per complete pixel, at least 1
// Returns 0, or -(y + 1) when row y carries an unknown filter type.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int gp2_png_unfilter(const uint8_t* in, uint8_t* out, int64_t h, int64_t stride,
                                int bpp) {
  uint8_t* zero = static_cast<uint8_t*>(calloc(stride > 0 ? stride : 1, 1));
  int rc = 0;
  for (int64_t y = 0; y < h && rc == 0; ++y) {
    const uint8_t* src = in + y * (stride + 1);
    const uint8_t f = src[0];
    ++src;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : zero;
    switch (f) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) dst[i] = src[i] + up[i];
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = src[i] + static_cast<uint8_t>((left + up[i]) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up[i];
          const int c = i >= bpp ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = src[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        rc = -static_cast<int>(y + 1);
    }
  }
  free(zero);
  return rc;
}
