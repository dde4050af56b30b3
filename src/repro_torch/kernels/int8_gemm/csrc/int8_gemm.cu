// INT8 x INT8 -> INT32 GEMM with per-row / per-column dequant scales, for
// Hopper (sm_90a): the INT8 prefill mode of the EVA PE array.
//
// Replaces the Pallas TPU kernel `_int8_gemm_kernel` / `int8_gemm_pallas`
// (src/repro/kernels/int8_gemm/kernel.py:22 and :44): xq (M, K) int8 and
// wq (K, N) int8, both row-major, xs (M, 1) and ws (1, N) fp32 ->
// y (M, N) fp32 = float(sum_k xq * wq) * xs * ws. The int32 sum is exact;
// the scales are applied as (acc * xs) * ws, in the Pallas kernel's order
// (kernel.py:36-40), so y is bit-equal to the plain version.
//
// Bound on this card: bytes at the serving shapes (the 4096 x 32000
// lm_head at M <= 256: 131 MB of int8 weight and the fp32 output against
// 2*M*N*K int8 operations at 1979 TOP/s).
//
// Design. A simple tiled kernel on the s8 tensor cores: a CTA computes a
// 128 x 128 tile of y with 8 warps (2 along M x 4 along N, each 64 x 32)
// issuing `mma.sync.m16n8k32.s8.s8.s32`, K walked in 64-deep steps. The
// A tile is staged row-major in shared memory; the B operand wants 4
// consecutive k of one column packed per register, so each thread loads a
// 4k x 4n block of wq (coalesced along N), transposes its bytes in
// registers and stores it k-contiguous per column. Rows of both tiles are
// padded to 80 bytes, so the fragment reads hit 32 distinct banks. The
// next K step's global loads are issued into registers before the current
// step's products (one-deep software pipeline); no TMA or wgmma yet.
// Rows past M, columns past N and k past K are zero-filled and never
// stored. CTAs along M are adjacent in launch order, so the CTAs that
// share a column tile of wq read it from L2 together.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;
constexpr int STRIDE = BK + 16;  // bytes per staged row (A: per m, B: per n)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte j of r[0..3] -> one word (r[0]'s byte lowest): column j of a 4x4
// byte block, k-contiguous
__device__ __forceinline__ uint32_t column_bytes(const uint32_t (&r)[4], int j) {
  const int sh = 8 * j;
  return ((r[0] >> sh) & 0xffu) | (((r[1] >> sh) & 0xffu) << 8) |
         (((r[2] >> sh) & 0xffu) << 16) | (((r[3] >> sh) & 0xffu) << 24);
}

__global__ void __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[BM * STRIDE];  // [m][k]
  __shared__ __align__(16) uint8_t Bs[BN * STRIDE];  // [n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A: 512 chunks of 16 bytes (row = c / 4, k = (c % 4) * 16); two a thread
  // B: 512 blocks of 4k x 4n, two a thread; a warp takes 4 k-quads x 8
  // n-quads, so each of its row loads fills whole 32-byte sectors and its
  // transposed stores conflict at most 4 ways
  auto b_block = [](int bb, int& kq, int& nq) {
    const int l = bb & 31, grp = bb >> 5;
    kq = (grp >> 2) * 4 + (l >> 3);
    nq = (grp & 3) * 8 + (l & 7);
  };
  uint4 ra[2];
  uint32_t rb[2][4];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 16;
      const int m = m0 + row, k = k0 + kc;
      ra[i] = (m < M && k < K)
                  ? *reinterpret_cast<const uint4*>(xq + (size_t)m * K + k)
                  : make_uint4(0u, 0u, 0u, 0u);
      int kq, nq;
      b_block(tid + i * THREADS, kq, nq);
      const int n = n0 + nq * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kk = k0 + kq * 4 + r;
        rb[i][r] = (kk < K && n < N)
                       ? *reinterpret_cast<const uint32_t*>(wq + (size_t)kk * N + n)
                       : 0u;
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (c >> 2) * STRIDE + (c & 3) * 16) = ra[i];
      int kq, nq;
      b_block(tid + i * THREADS, kq, nq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(Bs + (nq * 4 + j) * STRIDE + kq * 4) =
            column_bytes(rb[i], j);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_k = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < n_k; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < n_k) load((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = As + (wm * 64 + i * 16 + g) * STRIDE + ks + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * STRIDE + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = Bs + (wn * 32 + j * 8 + g) * STRIDE + ks + 4 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= N) continue;  // N is even, so n + 1 < N too
        float2 out;
        out.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), sx), ws[n]);
        out.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), sx),
                          ws[n + 1]);
        *reinterpret_cast<float2*>(y + (size_t)m * N + n) = out;
      }
    }
  }
}

}  // namespace

// K % 16 == 0 and N % 4 == 0 (the wrapper pads); all pointers 16-byte aligned
extern "C" int int8_gemm_launch(const void* xq, const void* wq, const void* xs,
                                const void* ws, void* y, int M, int N, int K,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(y), M, N, K);
  return (int)cudaGetLastError();
}
