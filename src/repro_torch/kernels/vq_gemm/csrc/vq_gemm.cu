// VQ-GEMM for Hopper (sm_90a): the output codebook O = X · B of EVA's
// first step, written to device memory for the lookup kernel (oc_lookup.cu)
// to read — the first half of the two-kernel `eva_split` backend.
//
// Replaces the Pallas TPU kernel `_vq_gemm_kernel` / `vq_gemm_pallas`
// (src/repro/kernels/vq_gemm/kernel.py:24 and :32):
//
//   O[c, r, e] = sum_{i < 8} x[r, i] * B[c, i, e]     r < M*V, e < 256
//
// Bound on this card: bytes. Each output entry is a d=8 contraction, 16
// flops, against 4 bytes of O written; the (C, M*V, 256) fp32 output
// dwarfs the inputs (x is M*V*32 bytes, B is C*8 KB). For llama2-7b's
// grouped `wqkv` at M=4 (V=512, C=2) O is 4.19 MB: 1.28 us at 3.35 TB/s.
//
// Design. The Pallas kernel runs one MXU dot per (codebook, M*V tile); a
// d=8 contraction is far too shallow for the tensor cores, so here it is
// fp32 FMAs on the CUDA cores, in the fixed order i = 0..7 (as the
// reference's fp32 dot_general):
//   * a CTA owns (codebook c, a slab of ROWS rows of M*V); its 256 threads
//     split the 256 centroids into 64 groups of 4 adjacent ones, so a
//     thread writes 16 contiguous bytes of an O row and a warp writes two
//     whole 512-byte row segments (coalesced stores);
//   * the 8 x 4 codebook entries a thread needs are loaded once into
//     registers; the slab's x rows are read as broadcasts (one row serves
//     the 64 threads of its centroid groups);
//   * the ragged end of M*V is masked in the kernel, nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 256;                   // 2^n centroids, n = 8
constexpr int D = 8;                      // VQ vector dimension
constexpr int COLS = 4;                   // adjacent centroids per thread
constexpr int GROUPS = KC / COLS;         // threads per O row
constexpr int ROWS_PER_PASS = THREADS / GROUPS;
constexpr int ROWS = 16;                  // O rows per CTA

__global__ void __launch_bounds__(THREADS)
vq_gemm_kernel(const float* __restrict__ x,     // (MV, D)
               const float* __restrict__ cb,    // (C, D, KC)
               float* __restrict__ O,           // (C, MV, KC)
               int MV) {
  const int c = blockIdx.y;
  const int g = threadIdx.x % GROUPS;
  const int e = g * COLS;
  float b[D][COLS];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int q = 0; q < COLS; ++q)
      b[i][q] = cb[((size_t)c * D + i) * KC + e + q];

  const int r0 = (int)blockIdx.x * ROWS;
  const int r_end = min(MV, r0 + ROWS);
  for (int r = r0 + (int)threadIdx.x / GROUPS; r < r_end;
       r += ROWS_PER_PASS) {
    float xv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) xv[i] = x[(size_t)r * D + i];
    float s[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      s[q] = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s[q] = fmaf(xv[i], b[i][q], s[q]);
    }
    *reinterpret_cast<float4*>(O + ((size_t)c * MV + r) * KC + e) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

}  // namespace

// x (MV, 8) fp32, cb (C, 8, 256) fp32, O (C, MV, 256) fp32 (16-byte
// aligned: the wrapper allocates it). Launches on `stream`.
extern "C" int vq_gemm_launch(const void* x, const void* cb, void* O, int MV,
                              int C, void* stream) {
  if (MV < 1 || C < 1 || C > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((MV + ROWS - 1) / ROWS, C);
  vq_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<float*>(O), MV);
  return (int)cudaGetLastError();
}
