// 3x3 SAME stride-1 convolution in NHWC / HWIO as an implicit GEMM:
//   y[n,h,w,co] = sum_{ky,kx,ci} x[n, h+ky-1, w+kx-1, ci] * w[ky,kx,ci,co]
// with zero outside the image, fp32 accumulation, y stored in x's dtype
// (float32 or bfloat16).
//
// Replaces the TPU kernel ddp_tpu/ops/conv_candidates.py::_pallas_fwd (inner
// `kernel`, block size from `_pick_block_n`).  On the TPU a grid step holds a
// zero-padded batch tile in VMEM and accumulates nine [bn*H*W, Cin] @
// [Cin, Cout] MXU dots over its shifted views.  Here the GEMM is
// M = N*H*W output pixels, N = Cout, K = 9*Cin:
//   - each block owns a 64-pixel x 64-channel output tile; its 256 threads
//     hold 4x4 fp32 accumulators each;
//   - the K loop walks the nine taps, and for each tap the input channels in
//     chunks of 16.  A chunk stages the shifted input pixels (A, 64 x 16) and
//     the tap's weights (B, 16 x 64) in shared memory as fp32, then every
//     thread runs 16 x 16 FFMAs on the CUDA cores;
//   - SAME padding is applied in the load: a shifted pixel outside the image
//     (or past the last pixel) loads zeros, so the input is never padded in
//     device memory as the TPU wrapper does (`_pad_hw`);
//   - every edge is masked (the pixel count, Cout, the last Cin chunk), so
//     Cin = 3, Cout = 8 and H = 4 all work; offsets are 64-bit.
// The same kernel computes the input gradient: dgrad of a SAME 3x3 conv is
// this conv of dy with the spatially flipped, in/out-transposed weights.
//
// Bound: operations.  The conv does 2*N*H*W*Cout*9*Cin FLOPs (77.3 GFLOP at
// both probe shapes at batch 512) on at most ~400 MB of input and output, so
// at the CUDA-core fp32 rate (66.9 TFLOP/s on an H100 SXM, 1.16 ms) it takes
// ten to forty times its bytes time at 3.35 TB/s (0.12 and 0.03 ms).  The design keeps fp32 semantics, as the reference
// does, and so stays off TF32 and the tensor cores; what it does about the
// bound is to give each thread 16 FFMAs for every two shared-memory reads
// and to keep enough 256-thread blocks in flight to fill all SMs.  Not done
// yet: bfloat16 through the tensor cores (wgmma), a TMA ring that overlaps
// loads with the FFMAs, and reuse of one halo tile across the nine taps.
// Shared memory is 8.5 KB a block, under the 48 KB that needs
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // input channels per K step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps the A tile's rows 16-byte aligned

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int n, int h, int wd, int cin, int cout) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // [k][pixel]
  __shared__ __align__(16) float Bs[BK][BN];         // [k][channel]

  const int tid = threadIdx.x;
  const long long m_total = static_cast<long long>(n) * h * wd;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: pixel a_m of the tile, input channels a_k .. a_k+3 of a chunk.
  const int a_m = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const long long am = m0 + a_m;
  const bool a_row_ok = am < m_total;
  int a_img = 0, a_y = 0, a_x = 0;
  if (a_row_ok) {
    a_x = static_cast<int>(am % wd);
    const long long t = am / wd;
    a_y = static_cast<int>(t % h);
    a_img = static_cast<int>(t / h);
  }
  // B loads: row b_k of a chunk, output channels b_n .. b_n+3 of the tile.
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 4;
  // Outputs: pixels ty*4 .. ty*4+3, channels tx*4 .. tx*4+3 of the tile.
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int sy = a_y + tap / 3 - 1;
    const int sx = a_x + tap % 3 - 1;
    const bool a_ok = a_row_ok && sy >= 0 && sy < h && sx >= 0 && sx < wd;
    const long long a_off =
        a_ok ? ((static_cast<long long>(a_img) * h + sy) * wd + sx) * cin : 0;
    const long long b_off = static_cast<long long>(tap) * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + a_k + j;
        As[a_k + j][a_m] = (a_ok && c < cin) ? to_float(x[a_off + c]) : 0.f;
      }
      const int cb = c0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + b_n + j;
        Bs[b_k][b_n + j] =
            (cb < cin && co < cout)
                ? to_float(w[b_off + static_cast<long long>(cb) * cout + co])
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < cout) y[m * cout + co] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int n, int h, int wd,
            int cin, int cout, cudaStream_t stream, long long m_blocks,
            int n_blocks) {
  const dim3 grid(static_cast<unsigned int>(m_blocks),
                  static_cast<unsigned int>(n_blocks));
  conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      n, h, wd, cin, cout);
}

}  // namespace

// Launches the conv on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  x: [n, h, wd, cin] contiguous; w: [3, 3, cin, cout]
// contiguous; y: [n, h, wd, cout] contiguous, all of one dtype:
// dtype 0 = float32, 1 = bfloat16.
extern "C" int ddp_conv3x3(const void* x, const void* w, void* y, int n,
                           int h, int wd, int cin, int cout, int dtype,
                           void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m_total = static_cast<long long>(n) * h * wd;
  const long long m_blocks = (m_total + BM - 1) / BM;
  const int n_blocks = (cout + BN - 1) / BN;
  if (m_blocks > 0x7fffffffLL || n_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, n, h, wd, cin, cout, s, m_blocks, n_blocks);
  } else {
    launch<__nv_bfloat16>(x, w, y, n, h, wd, cin, cout, s, m_blocks,
                          n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
