// VQ-GEMM for Hopper (sm_90a): the output codebook O = X · B of EVA's
// first step, written to device memory for the lookup kernel (oc_lookup.cu)
// to read — the first half of the two-kernel `eva_split` backend.
//
// Replaces the Pallas TPU kernel `_vq_gemm_kernel` / `vq_gemm_pallas`
// (src/repro/kernels/vq_gemm/kernel.py:24 and :32):
//
//   O[c, r, e] = sum_{i < 8} x[r, i] * B[c, i, e]     r < M*V, e < 256
//
// Bound on this card: bytes, and all but a few of them are O's writes.
// Each output entry is a d=8 contraction, 16 flops, against 4 bytes of O
// written; the (C, M*V, 256) fp32 output dwarfs the inputs (x is M*V*16
// bytes in bf16, B is C*8 KB). For llama2-7b's grouped `wqkv` at M=4
// (V=512, C=2) O is 4.19 MB: 1.25 us at 3.35 TB/s.
//
// Design. A d=8 contraction is far too shallow for the tensor cores, so
// it is fp32 FMAs on the CUDA cores, in the fixed order i = 0..7 (as the
// reference's fp32 dot_general); what the design is about is keeping a
// call's fixed cost short and O's writes in flight:
//   * x is read as stored, bf16 or fp32 (a template), and widened in
//     registers, as the Pallas kernel casts inside (bf16 -> fp32 is
//     exact, so O does not depend on x's dtype): one call, one kernel;
//   * few long-lived CTAs, sized from the SM count (vq_gemm/ops.py
//     `launch_shape`): a CTA owns a contiguous run of `rows` rows of M*V
//     for every codebook c, so its rows of one codebook are one
//     contiguous region of O. Its x rows are staged in shared memory
//     once for all C; its 256 threads split the 256 centroids into 64
//     groups of 4 adjacent ones, and each thread loads its 8 x 4
//     codebook entries of codebook c into registers with 16-byte loads
//     once per CTA (the next codebook's while this one's rows are
//     written). The codebook and x loads are issued together, so a CTA
//     waits for one memory round trip before its first output;
//   * O's writes: straight from registers, one 16-byte st.global.v4 a
//     thread and row (a warp writes two whole 512-byte row segments),
//     every row's store issued back to back with nothing waiting on it,
//     so a CTA's writes are all in flight at once. Staging tiles in shared
//     memory and writing them with 1-D bulk asynchronous copies
//     (cp.async.bulk, TMA's 1-D form) measured slower on the card, as each
//     tile costs a block barrier; an L2 evict-last hint on O's writes
//     moved the lookup kernel that reads O next by at most ~1 %, within
//     its run-to-run spread, so O's stores keep the default policy
//     (PERF.md);
//   * what a call costs is mostly fixed: the launch, and one round trip
//     for the codebook and x (chip_smoke.py breakdown: the `empty`,
//     `no_load` and `no_store` variants);
//   * the ragged end of M*V is masked in the kernel, nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef EVA_VARIANT
#define EVA_VARIANT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int KC = 256;                   // 2^n centroids, n = 8
constexpr int D = 8;                      // VQ vector dimension
constexpr int COLS = 4;                   // adjacent centroids per thread
constexpr int GROUPS = KC / COLS;         // threads per O row
constexpr int ROWS_PER_PASS = THREADS / GROUPS;
constexpr int ROWS_MAX = 256;             // rows a CTA (x staged once); ops.ROWS_MAX

// Timing-only variants, built with -DEVA_VARIANT=k (kernels/build.py
// VARIANTS) for chip_smoke.py's breakdown phase; 0 is the kernel.
//   1 no_store: loads and FMAs, O not written (wrong O);
//   2 no_load:  O written from constants, no x or codebook loads (wrong O);
//   3 empty:    the same grid, every CTA returns at entry (no O).
constexpr int kVariant = EVA_VARIANT;
constexpr int kNoStore = 1, kNoLoad = 2, kEmpty = 3;

__device__ __forceinline__ void load_codebook(float4 (&b)[D],
                                              const float* __restrict__ cb,
                                              int c, int e) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if constexpr (kVariant == kNoLoad)
      b[i] = make_float4(i + 1.f, e, c, 0.5f);
    else
      b[i] = __ldg(reinterpret_cast<const float4*>(cb + ((size_t)c * D + i) * KC + e));
  }
}

// the CTA's n rows of x, widened to fp32, into xs (n x 8)
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x,
                                        int r0, int n) {
  const float4* src = reinterpret_cast<const float4*>(x + (size_t)r0 * D);
  for (int j = threadIdx.x; j < n * 2; j += THREADS)
    reinterpret_cast<float4*>(xs)[j] =
        kVariant == kNoLoad ? make_float4(j, 1.f, 2.f, 3.f) : __ldg(src + j);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void stage_x(float* xs, const uint16_t* __restrict__ x,
                                        int r0, int n) {
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r0 * D);
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const uint4 w = kVariant == kNoLoad ? make_uint4(j, 1u, 2u, 3u) : __ldg(src + j);
    float4* dst = reinterpret_cast<float4*>(xs + j * D);
    dst[0] = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
    dst[1] = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
  }
}

// one thread's 4 outputs of row xr: fused multiply-adds in the order 0..7
__device__ __forceinline__ float4 row_dot(const float* xr, const float4 (&b)[D]) {
  const float4 xa = reinterpret_cast<const float4*>(xr)[0];
  const float4 xb = reinterpret_cast<const float4*>(xr)[1];
  const float xv[D] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s.x = fmaf(xv[i], b[i].x, s.x);
    s.y = fmaf(xv[i], b[i].y, s.y);
    s.z = fmaf(xv[i], b[i].z, s.z);
    s.w = fmaf(xv[i], b[i].w, s.w);
  }
  return s;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
vq_gemm_kernel(const XT* __restrict__ x,        // (MV, D), bf16 or fp32
               const float* __restrict__ cb,    // (C, D, KC)
               float* __restrict__ O,           // (C, MV, KC), 16-byte aligned
               int MV, int C, int rows) {
  __shared__ __align__(16) float xs[ROWS_MAX * D];
  if constexpr (kVariant == kEmpty) return;
  const int tid = threadIdx.x;
  const int e = (tid % GROUPS) * COLS;
  const int rr = tid / GROUPS;
  const int r0 = (int)blockIdx.x * rows;
  const int n = min(rows, MV - r0);

  float4 b[D];
  load_codebook(b, cb, 0, e);
  stage_x(xs, x, r0, n);
  __syncthreads();
  float sink = 0.f;                     // keeps no_store's FMAs alive
  for (int c = 0; c < C; ++c) {
    float4 next[D];
    if (c + 1 < C) load_codebook(next, cb, c + 1, e);
    float* Oc = O + ((size_t)c * MV + r0) * KC;
#pragma unroll 4
    for (int r = rr; r < n; r += ROWS_PER_PASS) {
      const float4 s = row_dot(xs + r * D, b);
      if constexpr (kVariant == kNoStore)
        sink += s.x + s.y + s.z + s.w;
      else
        *reinterpret_cast<float4*>(Oc + (size_t)r * KC + e) = s;
    }
    if (c + 1 < C) {
#pragma unroll
      for (int i = 0; i < D; ++i) b[i] = next[i];
    }
  }
  if constexpr (kVariant == kNoStore) {
    if (sink == 1.5e-45f) O[tid] = sink;  // never taken; not foldable
  }
}

}  // namespace

// x (MV, 8) bf16 (x_bf16 != 0) or fp32, 16-byte aligned; cb (C, 8, 256)
// fp32; O (C, MV, 256) fp32, 16-byte aligned (the wrapper allocates it).
// CTA b covers rows [b * rows, min(MV, (b + 1) * rows)) of every
// codebook (ops.launch_shape). Launches on `stream`.
extern "C" int vq_gemm_launch(const void* x, const void* cb, void* O, int MV,
                              int C, int rows, int x_bf16, void* stream) {
  if (MV < 1 || C < 1 || rows < 1 || rows > ROWS_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((MV + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* B = static_cast<const float*>(cb);
  float* out = static_cast<float*>(O);
  if (x_bf16)
    vq_gemm_kernel<<<grid, THREADS, 0, st>>>(static_cast<const uint16_t*>(x),
                                             B, out, MV, C, rows);
  else
    vq_gemm_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), B,
                                             out, MV, C, rows);
  return (int)cudaGetLastError();
}
