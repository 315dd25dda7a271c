// 3x3 SAME stride-1 convolution in NHWC / HWIO as an implicit GEMM:
//   y[n,h,w,co] = sum_{ky,kx,ci} x[n, h+ky-1, w+kx-1, ci] * w[ky,kx,ci,co]
// with zero outside the image, fp32 accumulation, y stored in x's dtype
// (float32 or bfloat16).
//
// Replaces the TPU kernel ddp_tpu/ops/conv_candidates.py::_pallas_fwd (inner
// `kernel`, block size from `_pick_block_n`).  On the TPU a grid step holds a
// zero-padded batch tile in VMEM and accumulates nine [bn*H*W, Cin] @
// [Cin, Cout] MXU dots over its shifted views.  Here the GEMM is
// M = N*H*W output pixels, N = Cout, K = 9*Cin, walked tap by tap.  The same
// kernels compute the input gradient: dgrad of a SAME 3x3 conv is this conv
// of dy with the spatially flipped, in/out-transposed weights.  SAME padding
// is applied in the load (a shifted pixel outside the image reads zero), so
// the input is never padded in device memory as the TPU wrapper does
// (`_pad_hw`).  Offsets are 64-bit.
//
// The conv does 2*N*H*W*Cout*9*Cin FLOPs: 77.3 GFLOP at both probe shapes at
// batch 512, on 0.05..0.4 GB of input and output.  Three routes; the wrapper
// (ops/conv_candidates.py::conv3x3_route) picks one from the shape and dtype
// before the launch:
//
// - wgmma_bf16 (ddp_conv3x3_bf16_wgmma): bfloat16 on the tensor cores.
//   Bound: operations at 989 TFLOP/s (0.078 ms at the probe shapes), with
//   the bytes (0.016..0.060 ms at 3.35 TB/s) close behind, so both the
//   tensor cores and the loads have to stream.  An output tile is 128
//   pixels x 128 channels (64 where Cout <= 64); two consumer warpgroups
//   each hold 64 x 128 fp32 sums in registers and run wgmma.m64n128k16 (or
//   m64n64k16) on shared memory.  One producer thread keeps a 3-stage TMA
//   ring full (mbarrier full/empty pairs): per stage the 128 shifted input
//   pixels x 64 channels (a 4-D box of whole image rows, or of whole images
//   when an image is smaller than 128 pixels) and the tap's weights.  TMA
//   fills every element outside the tensor with zero, which is the SAME
//   padding and the masking of a ragged batch, Cin or Cout.  The 128 B
//   swizzle puts each tile in the layout the wgmma descriptors read.
//   Weights arrive K-major ([9, Cout, Cin], repacked by the wrapper).  The
//   grid is persistent, as many blocks as fit (two an SM for 128-channel
//   tiles: 97 KB of shared memory each), and a block walks many tiles:
//   with K only 9*Cin deep (576 at Cin = 64) a tile is short, so the
//   producer loads the next tile while the consumers store this one.  The
//   store needs no shared memory: the four lanes that share an output row
//   swap their sums with shuffles, then each writes 16 consecutive bytes.
//   Not done: reuse of one halo tile across the nine
//   taps (each tap reloads its box, from L2 mostly).  Takes Cin and Cout
//   multiples of 8 (TMA's 16 B strides), a 16 B aligned x, and H, W whose
//   rows or images tile 128 pixels.
// - ffma_f32 (ddp_conv3x3_f32_tiled): float32 on the CUDA cores, no TF32
//   (the f32 contract is full fp32, as in the reference).  Bound:
//   operations at 66.9 TFLOP/s (1.16 ms); the bytes take a tenth of that.
//   A 256-thread block (one an SM: 167 registers a thread) owns 128 x 128
//   outputs (128 x 64 where Cout <= 64), 8 x 8 per thread, so a thread does
//   128 FFMAs for every 12 shared-memory loads (8 of them broadcasts of two
//   addresses a warp).  cp.async with a zero-fill source size (the SAME
//   padding) double-buffers 16-channel chunks, so the loads of chunk k+1 run
//   under the FFMAs of chunk k with one barrier a chunk.  The A tile's rows are
//   padded to 20 floats, so the two rows a warp reads land in different
//   banks.  Takes Cin and Cout multiples of 4 (16 B copies) and 16 B
//   aligned x and w.
// - general (ddp_conv3x3): any shape, either dtype, e.g. VGG's conv0
//   (Cin = 3) and its dgrad (Cout = 3).  A 64 x 64 tile, 4 x 4 per thread,
//   16-channel chunks staged as fp32 in one 8.5 KB buffer, every edge
//   masked, single-element loads.
//
// Each entry point returns 0 when the launch was accepted, a CUDA error
// code when it was refused (cudaGetLastError), and for the wgmma route
// 1000 when the driver's cuTensorMapEncodeTiled was not found or
// 2000 + its CUresult when it refused a tensor map.

#include <cuda.h>  // CUtensorMap and its enums; the entry point is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

// ---------------------------------------------------------------- general

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

// ------------------------------------------------------------ ffma_f32

namespace f32t {

constexpr int BM = 128;       // output pixels per block
constexpr int BK = 16;        // input channels per stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x BN/16 outputs each
constexpr int AST = BK + 4;   // A row stride in floats (80 B, 16 B aligned)
constexpr int A_BUF = BM * AST;  // floats per A buffer

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 B with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// An output pixel's image, row and column; ok = false past the last pixel.
struct Pixel {
  int img, y, x;
  bool ok;
};

__device__ __forceinline__ Pixel pixel(long long p, long long m_total, int h,
                                       int wd) {
  const long long q = p < m_total ? p : 0;
  return {static_cast<int>(q / wd / h), static_cast<int>((q / wd) % h),
          static_cast<int>(q % wd), p < m_total};
}

// Four channels c .. c+3 of pixel `p` shifted by (dy, dx), zeros outside
// the image or past Cin.
__device__ __forceinline__ void load_a(float* dst, const float* x, Pixel p,
                                       int dy, int dx, int c, int h, int wd,
                                       int cin) {
  const int sy = p.y + dy, sx = p.x + dx;
  const bool ok = p.ok && sy >= 0 && sy < h && sx >= 0 && sx < wd && c < cin;
  cp_async16(dst,
             ok ? x + ((static_cast<long long>(p.img) * h + sy) * wd + sx) *
                          cin + c
                : x,
             ok);
}

// Output channels co .. co+3 of input channel c of tap `tap`, zeros past
// Cin or Cout.
__device__ __forceinline__ void load_b(float* dst, const float* w, bool col,
                                       int tap, int c, int co, int cin,
                                       int cout) {
  const bool ok = col && c < cin;
  cp_async16(dst, ok ? w + (static_cast<long long>(tap) * cin + c) * cout + co
                     : w,
             ok);
}

// BN output channels per block: 128, or 64 where Cout <= 64 (a 128-wide
// tile would spend half its FFMAs on masked channels).  One block an SM:
// the 8 x 8 tile takes 167 registers a thread (capped at 128 for two
// blocks, it spilled and ran 1-3% slower).
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int n, int h, int wd, int cin,
                   int cout) {
  constexpr int NQ = BN / 64;  // float4 column groups a thread
  constexpr int B_ROWS = THREADS / (BN / 4);  // B rows one pass loads
  constexpr int B_BUF = BK * BN;              // floats per B buffer
  __shared__ __align__(16) float As[2][BM][AST];  // [pixel][k]
  __shared__ __align__(16) float Bs[2][BK][BN];   // [k][channel]

  const int tid = threadIdx.x;
  const long long m_total = static_cast<long long>(n) * h * wd;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: pixels tid/4 and tid/4 + 64 of the tile, channels a_c .. a_c+3
  // of a chunk.  B loads: rows b_k + B_ROWS r of a chunk, channels
  // b_n .. b_n+3.
  const Pixel p0 = pixel(m0 + (tid >> 2), m_total, h, wd);
  const Pixel p1 = pixel(m0 + (tid >> 2) + 64, m_total, h, wd);
  const int a_c = (tid & 3) * 4;
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const bool b_col = n0 + b_n < cout;
  float* const a_dst0 = &As[0][tid >> 2][a_c];
  float* const a_dst1 = &As[0][(tid >> 2) + 64][a_c];
  float* const b_dst = &Bs[0][b_k][b_n];

  const int chunks = (cin + BK - 1) / BK;
  const int iters = 9 * chunks;
  // Issues the copies of chunk `it` into buffer `buf` and commits them.
  auto load = [&](int it, int buf) {
    const int tap = it / chunks;
    const int c0 = (it - tap * chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    load_a(a_dst0 + buf * A_BUF, x, p0, dy, dx, c0 + a_c, h, wd, cin);
    load_a(a_dst1 + buf * A_BUF, x, p1, dy, dx, c0 + a_c, h, wd, cin);
#pragma unroll
    for (int r = 0; r < BK / B_ROWS; ++r)
      load_b(b_dst + buf * B_BUF + r * B_ROWS * BN, w, b_col, tap,
             c0 + b_k + r * B_ROWS, n0 + b_n, cin, cout);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Outputs: pixels ty + 16 i, channels tx*4 + 64 j + (0..3) of the tile.
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][4 * NQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = 0.f;

  load(0, 0);
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    // Chunk `it` has landed, and every thread is done with chunk it-1,
    // whose buffer the next load overwrites.  (A deeper ring, 3 or 4
    // chunks in flight, measured no faster.)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (it + 1 < iters) load(it + 1, buf ^ 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float2*>(&As[buf][ty + 16 * i][kk]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float bv[4 * NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              &Bs[buf][kk + q][tx * 4 + 64 * j]);
          bv[4 * j] = b.x, bv[4 * j + 1] = b.y, bv[4 * j + 2] = b.z,
          bv[4 * j + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : a[i].y;
#pragma unroll
          for (int j = 0; j < 4 * NQ; ++j)
            acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int co = n0 + tx * 4 + 64 * j;
      if (co < cout)
        *reinterpret_cast<float4*>(&y[m * cout + co]) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
    }
  }
}

}  // namespace f32t

// ---------------------------------------------------------- wgmma_bf16

namespace tc {

constexpr int BM = 128;  // output pixels per block: 2 warpgroups x 64 rows
constexpr int BK = 64;   // input channels per stage: one 128 B swizzle row
constexpr int STAGES = 3;  // 4 stages (one block an SM) measured slower
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int A_BYTES = BM * BK * 2;       // 16 KB

// The shared memory of a block with BN output channels (128, or 64 where
// Cout <= 64): the ring, its barriers, and slack to align it to 1024 B.
template <int BN>
struct Smem {
  static constexpr int B_BYTES = BN * BK * 2;  // 16 or 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 B
// (64 bf16) with the 128 B swizzle, 1024 B aligned: 8-row groups 1024 B
// apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[32] += A(64 x 16, desc a) * B(16 x 64, desc b), both K-major.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64] += A(64 x 16, desc a) * B(16 x 128, desc b), both K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in place around the asynchronous wgmmas, so no
// other instruction defines them inside the pipeline (which would make
// ptxas serialise the wgmmas).
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Writes this thread's two rows (row, row + 8) of a warpgroup's BN bf16
// sums with 16 B stores: the four lanes that share a row swap their
// channel pairs (a 4 x 4 transpose in two shuffle rounds), so each lane then
// holds 8 consecutive channels.
template <int BN>
__device__ __forceinline__ void store_rows(const float* acc,
                                           __nv_bfloat16* __restrict__ y,
                                           long long m, long long m_total,
                                           int n0, int cout, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half, m += 8) {
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      uint32_t v[4];  // v[b]: channels 2t, 2t+1 of 8-channel block 4q+b
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * (4 * q + b) + 2 * half;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[j], acc[j + 1]);
        v[b] = *reinterpret_cast<const uint32_t*>(&pair);
      }
#pragma unroll
      for (int mask = 1; mask <= 2; mask <<= 1) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (b & mask) continue;
          const bool hi = (t & mask) != 0;
          const uint32_t got =
              __shfl_xor_sync(0xffffffffu, hi ? v[b] : v[b | mask], mask);
          if (hi)
            v[b] = got;
          else
            v[b | mask] = got;
        }
      }
      // Now v[b]: channels 2b, 2b+1 of block 4q+t.
      const int c = n0 + (4 * q + t) * 8;
      if (m < m_total && c < cout)
        *reinterpret_cast<uint4*>(y + m * cout + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// x is read through `xmap` ([N, H, W, Cin] as 4-D, box (64, W, box_h,
// box_n)), the K-major weights through `wmap` ([9, Cout, Cin] as 3-D, box
// (64, BN, 1)).  Persistent: block b computes tiles b, b + gridDim.x, ...
// of the 128-pixel x BN-channel output tiles (channel tile fastest), so the
// producer loads the next tile while the consumers store this one.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     __nv_bfloat16* __restrict__ y, int n, int h, int wd,
                     int cin, int cout, int box_h, int box_n) {
  constexpr int B_BYTES = Smem<BN>::B_BYTES;
  constexpr int STAGE_BYTES = Smem<BN>::STAGE_BYTES;
  constexpr int ACC = BN / 2;  // fp32 sums a thread: 64 rows x BN / 128
  extern __shared__ uint8_t smem_raw[];
  // The 128 B swizzle repeats every 1024 B: align the ring to that.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_ring = smem_addr(smem);
  const uint32_t b_ring = a_ring + STAGES * A_BYTES;
  const uint32_t full = a_ring + STAGES * STAGE_BYTES;  // STAGES barriers
  const uint32_t empty = full + STAGES * 8;             // STAGES barriers
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long m_total = static_cast<long long>(n) * h * wd;
  const int m_tiles = static_cast<int>((m_total + BM - 1) / BM);
  const int n_tiles = (cout + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int chunks = (cin + BK - 1) / BK;
  const int iters = 9 * chunks;
  if (tid >= CONSUMERS) {
    // Producer: one thread issues every TMA load of the block.
    if (tid == CONSUMERS) {
      int g = 0;  // stages filled so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m_tile = t / n_tiles;
        const int n0 = (t - m_tile * n_tiles) * BN;
        int img, row0;
        if (box_n == 1) {  // box_h whole rows of one image
          const int tiles_per_img = h / box_h;
          img = m_tile / tiles_per_img;
          row0 = (m_tile % tiles_per_img) * box_h;
        } else {           // box_n whole images
          img = m_tile * box_n;
          row0 = 0;
        }
        for (int it = 0; it < iters; ++it, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty + 8 * s, ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          const int tap = it / chunks;
          const int c0 = (it - tap * chunks) * BK;
          tma_load_4d(a_ring + s * A_BYTES, &xmap, full + 8 * s, c0,
                      tap % 3 - 1, row0 + tap / 3 - 1, img);
          tma_load_3d(b_ring + s * B_BYTES, &wmap, full + 8 * s, c0, n0, tap);
        }
      }
    }
    return;
  }
  // Consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of each tile.
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int row = wg * 64 + ((tid / 32) & 3) * 16 + lane / 4;
  int g = 0;  // stages consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m_tile = t / n_tiles;
    const int n0 = (t - m_tile * n_tiles) * BN;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int it = 0; it < iters; ++it, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      const uint64_t da = sw128_desc(a_ring + s * A_BYTES + wg * 64 * 128);
      const uint64_t db = sw128_desc(b_ring + s * B_BYTES);
      fence_operands<ACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        if constexpr (BN == 128)
          wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k);
        else
          wgmma_m64n64k16(acc, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      // Wait for this stage's products, then hand its buffers back.
      // (Keeping one group in flight measured slower: ptxas then serialises
      // the wgmmas.)
      wgmma_wait<0>();
      fence_operands<ACC>(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    store_rows<BN>(acc, y, static_cast<long long>(m_tile) * BM + row,
                   m_total, n0, cout, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// links nothing but the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with a 64-element innermost box, 128 B swizzle and
// zero fill outside the tensor.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                  int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A persistent grid: as many blocks as fit on the card at once (two an SM
// for 128-channel tiles), or one per tile if there are fewer tiles.
template <int BN>
int launch(long long tiles, const CUtensorMap& xmap, const CUtensorMap& wmap,
           void* y, int n, int h, int wd, int cin, int cout, int box_h,
           int box_n, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<BN>::BYTES);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_wgmma_kernel<BN>, THREADS, Smem<BN>::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const dim3 grid(static_cast<unsigned int>(tiles < resident ? tiles
                                                             : resident));
  conv3x3_wgmma_kernel<BN><<<grid, THREADS, Smem<BN>::BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), n, h, wd, cin, cout, box_h,
      box_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// general route.  x: [n, h, wd, cin] contiguous; w: [3, 3, cin, cout]
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

// ffma_f32 route.  float32 x [n, h, wd, cin], w [3, 3, cin, cout], y
// [n, h, wd, cout], contiguous and 16 B aligned; cin, cout multiples of 4.
extern "C" int ddp_conv3x3_f32_tiled(const void* x, const void* w, void* y,
                                     int n, int h, int wd, int cin, int cout,
                                     void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 4 || cout < 4 || cin % 4 != 0 ||
      cout % 4 != 0 || (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bn = cout <= 64 ? 64 : 128;
  const long long m_blocks =
      (static_cast<long long>(n) * h * wd + f32t::BM - 1) / f32t::BM;
  const int n_blocks = (cout + bn - 1) / bn;
  if (m_blocks > 0x7fffffffLL || n_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(m_blocks),
                  static_cast<unsigned int>(n_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (bn == 64) {
    f32t::conv3x3_f32_kernel<64><<<grid, f32t::THREADS, 0, s>>>(
        xf, wf, yf, n, h, wd, cin, cout);
  } else {
    f32t::conv3x3_f32_kernel<128><<<grid, f32t::THREADS, 0, s>>>(
        xf, wf, yf, n, h, wd, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

// wgmma_bf16 route.  bfloat16 x [n, h, wd, cin], K-major weights wk
// [9, cout, cin] (wk[ky*3+kx, co, ci] = w[ky, kx, ci, co]), y
// [n, h, wd, cout], contiguous and 16 B aligned; cin, cout multiples of 8.
// A tile is 128 pixels: box_h whole rows of one image (box_n = 1,
// box_h * wd = 128, h % box_h = 0) or box_n whole images (box_h = h,
// box_n * h * wd = 128).
extern "C" int ddp_conv3x3_bf16_wgmma(const void* x, const void* wk, void* y,
                                      int n, int h, int wd, int cin, int cout,
                                      int box_h, int box_n, void* stream) {
  const bool rows = box_n == 1 && box_h * wd == tc::BM && box_h <= h &&
                    h % box_h == 0;
  const bool images = box_h == h && box_n * h * wd == tc::BM;
  if (n < 1 || h < 1 || wd < 1 || cin < 8 || cout < 8 || cin % 8 != 0 ||
      cout % 8 != 0 || !(rows || images) || wd > 256 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bn = cout <= 64 ? 64 : 128;
  const long long m_blocks =
      (static_cast<long long>(n) * h * wd + tc::BM - 1) / tc::BM;
  const int n_blocks = (cout + bn - 1) / bn;
  if (m_blocks * n_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return 1000;
  CUtensorMap xmap, wmap;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(n)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(wd) * cin * 2,
                                   static_cast<cuuint64_t>(h) * wd * cin * 2};
  const cuuint32_t x_box[4] = {tc::BK, static_cast<cuuint32_t>(wd),
                               static_cast<cuuint32_t>(box_h),
                               static_cast<cuuint32_t>(box_n)};
  CUresult r = tc::make_map(encode, &xmap, x, 4, x_dims, x_strides, x_box);
  if (r != CUDA_SUCCESS) return 2000 + static_cast<int>(r);
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(cout), 9};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(cout) * cin * 2};
  const cuuint32_t w_box[3] = {tc::BK, static_cast<cuuint32_t>(bn), 1};
  r = tc::make_map(encode, &wmap, wk, 3, w_dims, w_strides, w_box);
  if (r != CUDA_SUCCESS) return 2000 + static_cast<int>(r);

  const long long tiles = m_blocks * n_blocks;
  return bn == 64 ? tc::launch<64>(tiles, xmap, wmap, y, n, h, wd, cin, cout,
                                   box_h, box_n, stream)
                  : tc::launch<128>(tiles, xmap, wmap, y, n, h, wd, cin,
                                    cout, box_h, box_n, stream);
}
