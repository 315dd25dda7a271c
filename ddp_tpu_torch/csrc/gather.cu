// Batched row gather for the resident data path: out[i] = table[clamp(idx[i], 0, M-1)].
//
// Replaces the TPU kernel ddp_tpu/ops/gather.py::_pallas_row_gather (body
// _copy_kernel, wrapper gather_rows, which clamps indices to [0, M-1]).  On
// the TPU the grid walks the rows in order and each grid step is one DMA of a
// whole row, its address read from scalar-prefetched indices.
//
// Bound: memory bytes.  The gather does no arithmetic; it reads N rows of D
// bytes and writes N rows of D bytes (2*N*D, 3.1 MB at the main path's N = 512
// rows of D = 3072 bytes).  At that size the launch itself (a few
// microseconds) is as large as the transfer at full memory rate, so the
// design aims to put every row's traffic in flight at once rather than to
// stream a long copy:
//   - one block per output row, so N = 512 rows spread over all 132 SMs with
//     several blocks each; every block loads its own index (there is no
//     scalar prefetch on Hopper) and clamps it;
//   - neighbouring threads move neighbouring words of the row, so each warp
//     issues fully coalesced 512-byte transactions;
//   - the word is the widest of 16/8/4/2/1 bytes that divides the row
//     byte-count and both base addresses, so the main path (D = 3072, tensors
//     from the caching allocator) moves 16-byte uint4 words, one per thread
//     (192 threads a row), and any other row size still works with whole
//     words and no tail.
// The kernel moves raw bytes, so the wrapper may pass a table of any dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Word, typename Index>
__global__ void row_gather_kernel(const Word* __restrict__ table,
                                  const Index* __restrict__ idx,
                                  Word* __restrict__ out,
                                  long long m, long long words_per_row) {
  const long long i = blockIdx.x;
  long long r = static_cast<long long>(idx[i]);
  r = r < 0 ? 0 : (r >= m ? m - 1 : r);
  const Word* src = table + r * words_per_row;
  Word* dst = out + i * words_per_row;
  for (long long w = threadIdx.x; w < words_per_row; w += blockDim.x) {
    dst[w] = src[w];
  }
}

template <typename Word, typename Index>
void launch(const void* table, long long m, long long row_bytes,
            const void* idx, long long n, void* out, cudaStream_t stream) {
  const long long words = row_bytes / static_cast<long long>(sizeof(Word));
  long long threads = ((words + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  row_gather_kernel<Word, Index><<<static_cast<unsigned int>(n),
                                   static_cast<unsigned int>(threads), 0,
                                   stream>>>(
      static_cast<const Word*>(table), static_cast<const Index*>(idx),
      static_cast<Word*>(out), m, words);
}

template <typename Index>
void launch_width(int width, const void* table, long long m,
                  long long row_bytes, const void* idx, long long n,
                  void* out, cudaStream_t stream) {
  switch (width) {
    case 16: launch<uint4, Index>(table, m, row_bytes, idx, n, out, stream); break;
    case 8: launch<uint2, Index>(table, m, row_bytes, idx, n, out, stream); break;
    case 4: launch<uint32_t, Index>(table, m, row_bytes, idx, n, out, stream); break;
    case 2: launch<uint16_t, Index>(table, m, row_bytes, idx, n, out, stream); break;
    default: launch<uint8_t, Index>(table, m, row_bytes, idx, n, out, stream); break;
  }
}

// The width in bytes of the words the kernel moves for these arguments.
int word_width(const void* table, long long row_bytes, const void* out) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  for (int w = 16; w > 1; w /= 2) {
    if (a % w == 0) return w;
  }
  return 1;
}

}  // namespace

// Launches the gather on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  table: [m, row_bytes] bytes; idx: n indices of
// idx_bytes (4 or 8) each; out: [n, row_bytes] bytes.  1 <= n < 2^31, m >= 1.
extern "C" int ddp_row_gather(const void* table, long long m,
                              long long row_bytes, const void* idx,
                              int idx_bytes, long long n, void* out,
                              void* stream) {
  if (m < 1 || n < 1 || n > 0x7fffffffLL || row_bytes < 1 ||
      (idx_bytes != 4 && idx_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = word_width(table, row_bytes, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    launch_width<int32_t>(width, table, m, row_bytes, idx, n, out, s);
  } else {
    launch_width<int64_t>(width, table, m, row_bytes, idx, n, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
