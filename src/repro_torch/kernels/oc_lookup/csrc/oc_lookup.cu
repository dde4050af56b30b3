// Output-codebook lookup for Hopper (sm_90a): EVA's second step, the
// gather + add-only reduction over an output codebook O that vq_gemm.cu
// wrote to device memory — the second half of the two-kernel `eva_split`
// backend.
//
// Replaces the Pallas TPU kernel `_oc_lookup_kernel` / `oc_lookup_pallas`
// (src/repro/kernels/oc_lookup/kernel.py:33 and :50):
//
//   y[m, j] = scale[j] * sum_c sum_v O[c, m, v, I[c, v, j]]
//
// Bound on this card: bytes. Each output is C*V adds against the C*V
// uint8 indices of its column; the index matrix (C*V*N bytes) and one read
// of O (C*M*V*1 KB) are the traffic. For llama2-7b's grouped `gu` at M=4
// (V=512, N=22016, C=2): 22.5 MB of indices + 4.2 MB of O, 8.1 us at
// 3.35 TB/s.
//
// Design. The TPU kernel keeps the (M, bn) output block in VMEM across an
// inner, sequential V grid axis. On Hopper CTAs run in no order, so:
//   * a CTA owns (N tile of 1024 columns, V range, M tile of <= 8 rows)
//     and walks its V range in slabs of `bv` rows, the sums of its 4
//     adjacent columns per thread staying in registers;
//   * per slab, every thread first issues all its index loads — 4 adjacent
//     columns per 4-byte load, so a warp reads 128 contiguous bytes of an
//     index row; the indices stay uint8 in device memory, never widened —
//     then the CTA copies the slab's O (C, mt, bv, 256) into shared memory
//     with 16-byte loads, and each thread gathers its columns from it and
//     adds in a fixed order (v, then c);
//   * a few column tiles cannot fill 132 SMs (N=4096 gives 4), so the V
//     ranges of one tile run on different CTAs, which write partial sums
//     to a (splits, M, N) workspace; a second small kernel adds them in
//     split order and applies the scale. No atomics: two runs are bitwise
//     equal. With one split the first kernel scales and writes y.
// The gather reads random words of a shared-memory row, so lanes of a warp
// collide on banks; the paper's conflict-free lookup order is left for a
// later version.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 256;                 // 2^n, n = 8
constexpr int COLS = 4;                 // adjacent output columns per thread
constexpr int BN = THREADS * COLS;      // output columns per CTA
constexpr int MT_MAX = 8;               // O rows of M per CTA
constexpr int IDX_REGS = 32;            // index words prefetched per slab
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block may use
constexpr int MAX_DEVICES = 64;

template <int C>
__global__ void __launch_bounds__(THREADS, 2)
oc_lookup_kernel(const float* __restrict__ O,       // (C, M, V, KC)
                 const uint8_t* __restrict__ idx,   // (C, V, N)
                 const float* __restrict__ scale,   // (N,)
                 float* __restrict__ out,           // y (M, N) or ws (splits, M, N)
                 int M, int V, int N, int bv, int v_per_split,
                 int final_scale) {
  constexpr int BV_MAX = IDX_REGS / C;
  extern __shared__ float4 smem4[];
  float* Os = reinterpret_cast<float*>(smem4);      // (C, mt, bv, KC)
  const int t = threadIdx.x;
  const int m0 = blockIdx.z * MT_MAX;
  const int mt = min(MT_MAX, M - m0);
  const int j0 = blockIdx.x * BN + t * COLS;
  const bool vec_ok = ((N & 3) == 0) &&
                      ((reinterpret_cast<uintptr_t>(idx) & 3) == 0);
  const int v_begin = blockIdx.y * v_per_split;
  const int v_end = min(V, v_begin + v_per_split);

  float acc[MT_MAX][COLS];
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m)
#pragma unroll
    for (int q = 0; q < COLS; ++q) acc[m][q] = 0.f;

  for (int vs = v_begin; vs < v_end; vs += bv) {
    const int nv = min(bv, v_end - vs);
    // issue every index load of this slab first, so they are in flight
    // together with the copy of the output-codebook slab
    uint32_t ib[BV_MAX][C];
#pragma unroll
    for (int vv = 0; vv < BV_MAX; ++vv) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ib[vv][c] = 0u;
        if (vv < nv && j0 < N) {
          const uint8_t* ip = idx + ((size_t)c * V + vs + vv) * N + j0;
          if (vec_ok) {
            ib[vv][c] = *reinterpret_cast<const uint32_t*>(ip);
          } else {
#pragma unroll
            for (int q = 0; q < COLS; ++q)
              if (j0 + q < N) ib[vv][c] |= (uint32_t)ip[q] << (8 * q);
          }
        }
      }
    }
    // copy O[c, m0 + m, vs : vs + nv, :] for every (c, m): nv contiguous
    // rows of 256 floats each, as float4
    const int row4 = KC / 4;
    const int n4 = C * mt * nv * row4;
    for (int e = t; e < n4; e += THREADS) {
      const int q = e % row4;
      const int row = e / row4;                 // (c, m, vv), vv fastest
      const int vv = row % nv;
      const int cm = row / nv;
      const int m = cm % mt;
      const int c = cm / mt;
      const float4* src = reinterpret_cast<const float4*>(
          O + (((size_t)c * M + m0 + m) * V + vs + vv) * KC) + q;
      smem4[(((size_t)c * mt + m) * bv + vv) * row4 + q] = *src;
    }
    __syncthreads();
    // lookup + add-only reduction over this slab, in (v, c) order
#pragma unroll
    for (int vv = 0; vv < BV_MAX; ++vv) {
      if (vv < nv) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint32_t w = ib[vv][c];
          const float* Oc = Os + ((size_t)c * mt * bv + vv) * KC;
#pragma unroll
          for (int m = 0; m < MT_MAX; ++m) {
            if (m < mt) {
              const float* Om = Oc + (size_t)m * bv * KC;
#pragma unroll
              for (int q = 0; q < COLS; ++q) acc[m][q] += Om[(w >> (8 * q)) & 0xffu];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (j0 >= N) return;
#pragma unroll
  for (int m = 0; m < MT_MAX; ++m) {
    if (m < mt) {
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        const int j = j0 + q;
        if (j < N) {
          if (final_scale)
            out[(size_t)(m0 + m) * N + j] = acc[m][q] * scale[j];
          else
            out[((size_t)blockIdx.y * M + m0 + m) * N + j] = acc[m][q];
        }
      }
    }
  }
}

// y[m, j] = scale[j] * sum_{s < splits} ws[s, m, j], summed in split order
__global__ void oc_split_reduce_kernel(const float* __restrict__ ws,
                                       const float* __restrict__ scale,
                                       float* __restrict__ y, int M, int N,
                                       int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[(size_t)p * MN + i];
  y[i] = s * scale[i % N];
}

// Raise the kernel's dynamic shared-memory limit once per device, not on
// every launch: the attribute call is host work on the decode step's
// critical path.
template <int C>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(oc_lookup_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}

template <int C>
cudaError_t launch_c(const void* O, const void* idx, const void* scale,
                     float* out, int M, int V, int N, int bv, int v_per_split,
                     int splits, int final_scale, size_t smem,
                     cudaStream_t st) {
  if (bv > IDX_REGS / C || smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<C>();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, splits, (M + MT_MAX - 1) / MT_MAX);
  oc_lookup_kernel<C><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(O), static_cast<const uint8_t*>(idx),
      static_cast<const float*>(scale), out, M, V, N, bv, v_per_split,
      final_scale);
  return cudaGetLastError();
}

}  // namespace

// O (C, M, V, 256) fp32, 16-byte aligned; idx (C, V, N) uint8; scale (N,)
// fp32; y (M, N) fp32; ws (splits, M, N) fp32 when splits > 1. Every
// split covers v_per_split rows of V (a multiple of bv) but the last.
extern "C" int oc_lookup_launch(const void* O, const void* idx,
                                const void* scale, void* y, void* ws, int M,
                                int V, int N, int C, int bv, int v_per_split,
                                int splits, void* stream) {
  if (M < 1 || V < 1 || N < 1 || bv < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt_alloc = M < MT_MAX ? M : MT_MAX;
  const size_t smem = (size_t)C * mt_alloc * bv * KC * sizeof(float);
  const bool direct = splits == 1;
  float* out = static_cast<float*>(direct ? y : ws);
  const int fs = direct ? 1 : 0;
  cudaError_t err;
  switch (C) {
    case 1: err = launch_c<1>(O, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 2: err = launch_c<2>(O, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 3: err = launch_c<3>(O, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 4: err = launch_c<4>(O, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || direct) return (int)err;
  const size_t MN = (size_t)M * N;
  oc_split_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<float*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
