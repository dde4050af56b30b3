// Conventional VQ matmul (rebuild the weight from its codebooks, then
// multiply) for Hopper (sm_90a): the prefill path of every VQ linear.
//
// Replaces the Pallas TPU kernel `_dequant_gemv_kernel` /
// `dequant_gemv_pallas` (src/repro/kernels/dequant_gemv/kernel.py:20 and
// :47): w[v, j, :] = sum_c cb[c, I[c, v, j], :] rebuilt tile by tile from
// uint8 indices, y += X . W with an fp32 accumulator, y *= scale at the end.
// x (M, V*d) fp32, codebooks (C, d, 2^n) fp32 as stored in the VQ weight,
// I (C, V, N) uint8, scale (N,) -> y (M, N) fp32.
//
// Bound on this card: operations. At a prefill bucket of M tokens the work
// is 2*M*K*N fp32 flops against C*V*N index bytes (M=256, K=4096: ~500
// flops per index byte), so the least time is the flops over the fp32 rate
// (67 TFLOP/s outside the tensor cores).
//
// Design. A classic shared-memory tiled SGEMM whose B operand is rebuilt on
// the fly: each CTA owns a 64x64 output tile, copies the codebooks once into
// shared memory in centroid-major (C, 2^n, d) order, and steps over K in
// slabs of 4 index rows (32 reduction elements). Per slab, each of its 256
// threads rebuilds one (v, j) weight vector of d=8 values from C indices
// (read as uint8) and writes it into the shared B tile, while the X tile is
// staged transposed; then each thread accumulates a 4x4 register tile. Each
// output is summed by one thread in K order: two runs are bitwise equal.
// Tensor cores (wgmma on bf16 tiles) are the next step for this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64;
constexpr int D = 8;
constexpr int BV = 4;            // index rows per slab
constexpr int BK = BV * D;       // reduction elements per slab
constexpr int KC = 256;          // 2^n centroids per codebook
constexpr int THREADS = 256;     // 16 x 16, 4x4 outputs each

__global__ void __launch_bounds__(THREADS)
dequant_gemv_kernel(const float* __restrict__ x,       // (M, V*D)
                    const float* __restrict__ cb,      // (C, D, KC)
                    const uint8_t* __restrict__ idx,   // (C, V, N)
                    const float* __restrict__ scale,   // (N,)
                    float* __restrict__ y,             // (M, N)
                    int M, int V, int N, int C) {
  extern __shared__ float smem[];
  float* cbs = smem;                          // (C, KC, D) centroid-major
  float* As = cbs + (size_t)C * KC * D;       // (BK, BM + 1) x tile, transposed
  float* Bs = As + BK * (BM + 1);             // (BK, BN) rebuilt weight tile

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = V * D;

  for (int e = t; e < C * D * KC; e += THREADS) {
    const int c = e / (D * KC);
    const int r = e - c * (D * KC);
    const int i = r / KC, kk = r - i * KC;
    cbs[((size_t)c * KC + kk) * D + i] = cb[e];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the (v, j) weight vector this thread rebuilds in every slab
  const int rv = t / BN, rj = t - rv * BN;
  for (int vs = 0; vs < V; vs += BV) {
    __syncthreads();  // previous slab consumed (and codebooks staged)
    for (int e = t; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e - r * BK;
      const int m = m0 + r, kk = vs * D + c;
      As[c * (BM + 1) + r] = (m < M && kk < K) ? x[(size_t)m * K + kk] : 0.f;
    }
    {
      const int v = vs + rv, j = n0 + rj;
      float w[D];
#pragma unroll
      for (int i = 0; i < D; ++i) w[i] = 0.f;
      if (v < V && j < N) {
        for (int c = 0; c < C; ++c) {
          const int e = idx[((size_t)c * V + v) * N + j];
          const float4* src = reinterpret_cast<const float4*>(cbs + ((size_t)c * KC + e) * D);
          const float4 a = src[0], b = src[1];
          w[0] += a.x; w[1] += a.y; w[2] += a.z; w[3] += a.w;
          w[4] += b.x; w[5] += b.y; w[6] += b.z; w[7] += b.w;
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i) Bs[(rv * D + i) * BN + rj] = w[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * (BM + 1) + ty * 4 + i];
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

}  // namespace

extern "C" int dequant_gemv_launch(const void* x, const void* cb,
                                   const void* idx, const void* scale,
                                   void* y, int M, int V, int N, int C,
                                   void* stream) {
  if (M < 1 || V < 1 || N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)C * KC * D + (size_t)BK * (BM + 1) + (size_t)BK * BN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dequant_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dequant_gemv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const uint8_t*>(idx), static_cast<const float*>(scale),
      static_cast<float*>(y), M, V, N, C);
  return (int)cudaGetLastError();
}
