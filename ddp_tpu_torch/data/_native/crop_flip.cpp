// Host-side CIFAR augmentation for the streaming path: RandomCrop(32, pad 4)
// + HFlip (counterpart of ddp_tpu/data/_native/crop_flip.cpp, byte for byte
// the same function).
//
// A host library, not a device kernel: each streamed batch is cropped and
// flipped here by the prefetch workers (data/prefetch.py) before it is
// pinned and copied to the card.  Pure memory movement: Python
// (data/augment.py) draws the offsets and flips and hands them over, so
// this and the numpy version are bit-identical on the same draws.
//
// Layout: images are [N, 32, 32, 3] uint8, C-contiguous.  Crop offsets
// (ys[i], xs[i]) are in [0, 8] and index the zero-padded 40x40 frame; the
// output pixel (y, x) reads padded (ys+y, xs+x), i.e. source
// (ys+y-4, xs+x-4) with zero fill outside, then a horizontal flip reverses
// x order when flips[i] is set.
//
// Built at first use by data/native.py (g++ -O3 -shared -fPIC -fopenmp);
// plain C ABI, loaded with ctypes, which releases the interpreter lock for
// the call.
#include <cstdint>
#include <cstring>

namespace {
constexpr int kSize = 32;
constexpr int kPad = 4;
constexpr int kCh = 3;
constexpr int kRow = kSize * kCh;      // bytes per image row
constexpr int kImg = kSize * kRow;     // bytes per image
}  // namespace

extern "C" void crop_flip_u8(const uint8_t* in, uint8_t* out,
                             const int64_t* ys, const int64_t* xs,
                             const uint8_t* flips, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* img = in + i * kImg;
    uint8_t* dst = out + i * kImg;
    const int y0 = static_cast<int>(ys[i]) - kPad;
    const int x0 = static_cast<int>(xs[i]) - kPad;
    const bool flip = flips[i] != 0;
    for (int y = 0; y < kSize; ++y) {
      uint8_t* drow = dst + y * kRow;
      const int sy = y + y0;
      if (sy < 0 || sy >= kSize) {
        std::memset(drow, 0, kRow);
        continue;
      }
      const uint8_t* srow = img + sy * kRow;
      // Valid source x range for this row: clip [x0, x0+32) to [0, 32).
      const int xlo = x0 < 0 ? -x0 : 0;            // first valid out-x
      const int xhi = x0 + kSize > kSize ? kSize - x0 : kSize;  // one past
      if (!flip) {
        if (xlo > 0) std::memset(drow, 0, xlo * kCh);
        if (xhi < kSize)
          std::memset(drow + xhi * kCh, 0, (kSize - xhi) * kCh);
        std::memcpy(drow + xlo * kCh, srow + (x0 + xlo) * kCh,
                    (xhi - xlo) * kCh);
      } else {
        // out x -> source (x0 + (31 - x)); write zero where out of range.
        for (int x = 0; x < kSize; ++x) {
          const int sx = x0 + (kSize - 1 - x);
          uint8_t* d = drow + x * kCh;
          if (sx < 0 || sx >= kSize) {
            d[0] = 0; d[1] = 0; d[2] = 0;
          } else {
            const uint8_t* s = srow + sx * kCh;
            d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
          }
        }
      }
    }
  }
}
