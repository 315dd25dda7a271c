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
//
// ---------------------------------------------------------------------------
// Resident batch: the whole input side of one resident train or eval step,
//   images[i] = crop_flip(table[r], ys[i], xs[i], flip[i]) / 255,
//   labels_out[i] = labels[r],  r = clamp(idx[i], 0, M-1),
// float32 or bfloat16, stored channels-first [N, 3, 32, 32] (the wrapper
// returns its NHWC view).  Train mode: image i is padded by PAD = 4 zeros, cropped at
// row ys[i], column xs[i], then mirrored left-right where flip[i].  Eval
// mode (no draws): offset PAD, no flip, so the image unchanged.
//
// Replaces the TPU kernel ddp_tpu/ops/gather.py:37 (_pallas_row_gather) and
// the JAX functions XLA fuses around it in the resident step:
// ddp_tpu/data/device_augment.py:44 (gather_crop_flip) and :57
// (_crop_flip_onehot, the crop/flip as one-hot matmuls), and
// ddp_tpu/train/step.py:53 (_as_input, the u8/255 cast).  On the card the
// row gather alone wrote uint8 NHWC, and some 26 eager launches followed it
// (the crop/flip's index arithmetic and gather, the label gather, the cast,
// the scale and the NCHW copy), each a pass over device memory.
//
// Bound: memory bytes.  A step's batch of N = 512 moves the 6.3 MB of float
// output, 1.6 MB of source rows and a few KB of indices, draws and labels:
// 7.9 MB, 2.35 us at 3.35 TB/s (bfloat16: 3.1 MB of output, 4.7 MB in all,
// 1.41 us).  That is about the cost of a launch and of
// the dependent chain index -> row -> output, so the design keeps one launch
// and puts every image's chain in flight at once:
//   - one 256-thread block per image: N = 512 is one wave of about four
//     blocks an SM.  Thread 0 loads and clamps the index and pulls the
//     3072-byte source image into shared memory with one bulk asynchronous
//     copy (cp.async.bulk, completed on an mbarrier by its byte count);
//   - while the copy is in flight, every thread loads the draws and makes
//     one entry of a 256-entry table of u/255 in the output type, and
//     thread 0 writes the label;
//   - after the barrier, thread t makes the 4 consecutive output pixels
//     (t % 8) * 4 .. + 3 of row t / 8 in each of the three channel planes,
//     reading the cropped and flipped source from shared memory and writing
//     zero outside the padded window, and stores them as one vector (16
//     bytes of float32, 8 of bfloat16): a warp writes 4 whole rows, 512 (or
//     256) contiguous bytes.  The stores are marked streaming (evict first):
//     the step reads each output once.
// u8/255 is an IEEE division (nvcc's default; no fast math), which is what
// the CPU and JAX's eager cast compute; a multiply by 1/255 differs from it
// in the last bit for 126 of the 256 byte values.  A division costs a dozen
// instructions, and twelve a thread made up much of the kernel's time, so
// each block divides once per byte value into the table and the pixels look
// their values up.  The bfloat16 form's table holds the float32 quotient
// rounded to nearest even, which is what JAX's u8.astype(bf16) / 255 gives
// for every byte value (the bf16 division is carried out in float32 and
// rounded once).  Variants measured on the card and not kept (PERF.md): two
// or four images per block, and plain write-back stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

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

// ----------------------------------------------------------- resident batch

constexpr int SIZE = 32;                      // image side
constexpr int PAD = 4;                        // RandomCrop's padding
constexpr int CHANNELS = 3;
constexpr int IMAGE_BYTES = SIZE * SIZE * CHANNELS;  // 3072, NHWC uint8
constexpr int PLANE = SIZE * SIZE;            // floats per output plane
constexpr int BATCH_THREADS = PLANE / 4;      // 4 output pixels a thread
static_assert(BATCH_THREADS == 256, "one thread per entry of the u/255 table");

// u / 255 in the output type, and four output pixels as one streaming store.
__device__ __forceinline__ void scale_byte(int u, float* v) {
  *v = static_cast<float>(u) / 255.0f;
}
__device__ __forceinline__ void scale_byte(int u, __nv_bfloat16* v) {
  *v = __float2bfloat16_rn(static_cast<float>(u) / 255.0f);
}
__device__ __forceinline__ void store4(float* dst, const float* v) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const __nv_bfloat16* v) {
  uint2 w;
  w.x = static_cast<uint32_t>(__bfloat16_as_ushort(v[0])) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(v[1])) << 16);
  w.y = static_cast<uint32_t>(__bfloat16_as_ushort(v[2])) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(v[3])) << 16);
  __stcs(reinterpret_cast<uint2*>(dst), w);
}

template <bool kAugment, typename Index, typename Out>
__global__ void __launch_bounds__(BATCH_THREADS)
gather_batch_kernel(const uint8_t* __restrict__ table, long long m,
                    const Index* __restrict__ idx,
                    const int64_t* __restrict__ labels,
                    const int64_t* __restrict__ ys,
                    const int64_t* __restrict__ xs,
                    const bool* __restrict__ flip, Out* __restrict__ out,
                    int64_t* __restrict__ labels_out) {
  __shared__ __align__(128) uint8_t img[IMAGE_BYTES];
  __shared__ __align__(8) uint64_t bar_word;
  __shared__ Out scaled[256];  // scaled[u] = u / 255, IEEE, then rounded
  const long long i = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t bar = smem_addr(&bar_word);
  long long r = 0;
  if (tid == 0) {
    r = static_cast<long long>(idx[i]);
    r = r < 0 ? 0 : (r >= m ? m - 1 : r);
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, IMAGE_BYTES);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(img)),
        "l"(table + r * IMAGE_BYTES), "r"(IMAGE_BYTES), "r"(bar)
        : "memory");
  }
  scale_byte(tid, &scaled[tid]);
  // Eval: the window at offset PAD, unflipped, is the image itself.
  long long oy = PAD, ox = PAD;
  bool mirror = false;
  if (kAugment) {
    oy = ys[i];
    ox = xs[i];
    mirror = flip[i];
  }
  __syncthreads();  // the barrier and the table are ready
  if (tid == 0) labels_out[i] = labels[r];

  const int y = tid / 8;
  const int x0 = (tid % 8) * 4;
  const long long sy = oy + y - PAD;
  const bool row_inside = sy >= 0 && sy < SIZE;
  int src[4];  // byte offset of each output pixel's source, -1 for zero
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = mirror ? SIZE - 1 - (x0 + j) : x0 + j;
    const long long sx = ox + col - PAD;
    src[j] = row_inside && sx >= 0 && sx < SIZE
                 ? static_cast<int>((sy * SIZE + sx) * CHANNELS)
                 : -1;
  }
  mbar_wait(bar, 0);
  Out* dst = out + i * (CHANNELS * PLANE) + y * SIZE + x0;
  // Zero outside the window: the table's entry for byte 0 is +0 in both types.
#pragma unroll
  for (int c = 0; c < CHANNELS; ++c) {
    Out v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = scaled[src[j] < 0 ? 0 : img[src[j] + c]];
    }
    store4(dst + c * PLANE, v);
  }
}

template <typename Index, typename Out>
void launch_batch(const void* table, long long m, const void* idx,
                  long long n, const void* labels, const void* ys,
                  const void* xs, const void* flip, void* out,
                  void* labels_out, cudaStream_t stream) {
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* ix = static_cast<const Index*>(idx);
  const auto* lab = static_cast<const int64_t*>(labels);
  auto* o = static_cast<Out*>(out);
  auto* lo = static_cast<int64_t*>(labels_out);
  const dim3 grid(static_cast<unsigned int>(n));
  if (ys != nullptr) {
    gather_batch_kernel<true, Index, Out><<<grid, BATCH_THREADS, 0, stream>>>(
        t, m, ix, lab, static_cast<const int64_t*>(ys),
        static_cast<const int64_t*>(xs), static_cast<const bool*>(flip), o,
        lo);
  } else {
    gather_batch_kernel<false, Index, Out><<<grid, BATCH_THREADS, 0, stream>>>(
        t, m, ix, lab, nullptr, nullptr, nullptr, o, lo);
  }
}

template <typename Index>
void launch_batch_out(int out_bytes, const void* table, long long m,
                      const void* idx, long long n, const void* labels,
                      const void* ys, const void* xs, const void* flip,
                      void* out, void* labels_out, cudaStream_t stream) {
  if (out_bytes == 4) {
    launch_batch<Index, float>(table, m, idx, n, labels, ys, xs, flip, out,
                               labels_out, stream);
  } else {
    launch_batch<Index, __nv_bfloat16>(table, m, idx, n, labels, ys, xs, flip,
                                       out, labels_out, stream);
  }
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

// Launches the resident-batch kernel on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).  table: [m, 32, 32, 3]
// uint8, 16 B aligned; idx: n indices of idx_bytes (4 or 8) each; labels: m
// int64; ys, xs: n int64 and flip: n bools, or all three null for the eval
// form; out: [n, 3, 32, 32] of out_bytes (4: float32, 2: bfloat16), 16 B
// aligned; labels_out: n int64.  1 <= n < 2^31, m >= 1.
extern "C" int ddp_gather_batch(const void* table, long long m,
                                const void* idx, int idx_bytes, long long n,
                                const void* labels, const void* ys,
                                const void* xs, const void* flip, void* out,
                                int out_bytes, void* labels_out,
                                void* stream) {
  const bool some_draws = ys != nullptr || xs != nullptr || flip != nullptr;
  const bool all_draws = ys != nullptr && xs != nullptr && flip != nullptr;
  if (m < 1 || n < 1 || n > 0x7fffffffLL ||
      (idx_bytes != 4 && idx_bytes != 8) || some_draws != all_draws ||
      (out_bytes != 4 && out_bytes != 2) ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    launch_batch_out<int32_t>(out_bytes, table, m, idx, n, labels, ys, xs,
                              flip, out, labels_out, s);
  } else {
    launch_batch_out<int64_t>(out_bytes, table, m, idx, n, labels, ys, xs,
                              flip, out, labels_out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
