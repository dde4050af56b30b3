// Fused EVA matmul for Hopper (sm_90a): y = x @ W_hat with W_hat held as
// C additive uint8-indexed codebooks, computed without ever rebuilding W.
//
// Replaces the Pallas TPU kernel `_fused_kernel` / `fused_vq_matmul_pallas`
// (src/repro/kernels/fused_vq_matmul/kernel.py:49 and :89):
//
//   O[c, m, v, :] = x[m, v, :] . B[c]                 (VQ-GEMM, d=8 deep)
//   y[m, j]       = scale[j] * sum_c sum_v O[c, m, v, I[c, v, j]]
//
// Bound on this card: bytes. At decode (M = a few slots) the work is
// C*M*V*(2^n*d*2 + N) flops against C*V*N index bytes; the index matrix
// dominates (12.6 MB for llama2-7b's grouped wqkv at 2 bits per weight),
// so the least time is the index bytes over 3.35 TB/s.
//
// Design. The Pallas kernel keeps one row block's whole O (C, M, V, 256)
// resident in VMEM across every N tile. At K=4096 that is 1 MiB per token
// row — far beyond the 227 KB of shared memory a block may use. So here:
//   * a CTA owns (N tile of 1024 columns, V range, M tile of <= 8 rows);
//   * it walks its V range in slabs of `bv` rows. Per slab, every thread
//     first issues all its index loads — 4 adjacent columns per 4-byte
//     load of the uint8 indices, which stay uint8 in device memory and are
//     never widened — so they are in flight together; meanwhile the CTA
//     recomputes the slab's O (C, mt, bv, 256) into shared memory from x
//     and the codebooks (one thread per centroid, its codebook column kept
//     in registers); then each thread gathers its 4 columns;
//   * sums stay in registers, in a fixed order (v, then c);
//   * the V ranges of one N tile run on different CTAs, which write partial
//     sums to a (splits, M, N) workspace; a second small kernel adds them
//     in split order and applies the scale. No atomics: two runs are
//     bitwise equal. With one split the first kernel scales and writes y.
// Recomputing O per N tile costs 2^n*d/1024 = 2 flops per lookup add; the
// wrapper sizes the V split so the grid fills the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // == centroids per codebook
constexpr int KC = 256;                 // 2^n, n = 8
constexpr int D = 8;                    // VQ vector dimension
constexpr int COLS = 4;                 // adjacent output columns per thread
constexpr int BN = THREADS * COLS;      // output columns per CTA
constexpr int MT_MAX = 8;               // x rows per CTA
constexpr int IDX_REGS = 32;            // index words prefetched per slab

// C codebooks; a slab is at most IDX_REGS / C index rows
template <int C>
__global__ void __launch_bounds__(THREADS, 2)
fused_vq_kernel(const float* __restrict__ x,        // (M, V, D)
                const float* __restrict__ cb,       // (C, D, KC)
                const uint8_t* __restrict__ idx,    // (C, V, N)
                const float* __restrict__ scale,    // (N,)
                float* __restrict__ out,            // y (M, N) or ws (splits, M, N)
                int M, int V, int N, int bv, int v_per_split,
                int final_scale) {
  constexpr int BV_MAX = IDX_REGS / C;
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.z * MT_MAX;
  const int mt = min(MT_MAX, M - m0);
  float* O = smem;                                  // (C, mt, bv, KC)
  float* xs = smem + (size_t)C * mt * bv * KC;      // (mt, bv, D)

  // codebook column e = t of every codebook, kept in registers
  float b[C][D];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < D; ++i) b[c][i] = cb[((size_t)c * D + i) * KC + t];

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
    // issue every index load of this slab first (4 columns per word), so
    // they are in flight together while the output codebook is computed
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
    // stage the x slab (mt rows of nv*D contiguous floats)
    for (int e = t; e < mt * nv * D; e += THREADS) {
      const int m = e / (nv * D);
      const int r = e - m * (nv * D);
      xs[m * bv * D + r] = x[((size_t)(m0 + m) * V + vs) * D + r];
    }
    __syncthreads();
    // VQ-GEMM: this slab of the output codebook, one centroid per thread
    for (int m = 0; m < mt; ++m) {
      for (int vv = 0; vv < nv; ++vv) {
        const float* xr = xs + (m * bv + vv) * D;
        float xv[D];
#pragma unroll
        for (int i = 0; i < D; ++i) xv[i] = xr[i];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) s = fmaf(xv[i], b[c][i], s);
          O[(((size_t)c * mt + m) * bv + vv) * KC + t] = s;
        }
      }
    }
    __syncthreads();
    // lookup + add-only reduction over this slab, in (v, c) order
#pragma unroll
    for (int vv = 0; vv < BV_MAX; ++vv) {
      if (vv < nv) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint32_t w = ib[vv][c];
          const float* Oc = O + ((size_t)c * mt * bv + vv) * KC;
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
__global__ void split_reduce_kernel(const float* __restrict__ ws,
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

template <int C>
cudaError_t launch_c(const void* x, const void* cb, const void* idx,
                     const void* scale, float* out, int M, int V, int N,
                     int bv, int v_per_split, int splits, int final_scale,
                     size_t smem, cudaStream_t st) {
  if (bv > IDX_REGS / C) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_vq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, splits, (M + MT_MAX - 1) / MT_MAX);
  fused_vq_kernel<C><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const uint8_t*>(idx), static_cast<const float*>(scale), out,
      M, V, N, bv, v_per_split, final_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_vq_matmul_launch(const void* x, const void* cb,
                                      const void* idx, const void* scale,
                                      void* y, void* ws, int M, int V, int N,
                                      int C, int bv, int v_per_split,
                                      int splits, void* stream) {
  if (M < 1 || bv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt_alloc = M < MT_MAX ? M : MT_MAX;
  const size_t smem =
      ((size_t)C * mt_alloc * bv * KC + (size_t)mt_alloc * bv * D) * sizeof(float);
  const bool direct = splits == 1;
  float* out = static_cast<float*>(direct ? y : ws);
  const int fs = direct ? 1 : 0;
  cudaError_t err;
  switch (C) {
    case 1: err = launch_c<1>(x, cb, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 2: err = launch_c<2>(x, cb, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 3: err = launch_c<3>(x, cb, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    case 4: err = launch_c<4>(x, cb, idx, scale, out, M, V, N, bv, v_per_split, splits, fs, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || direct) return (int)err;
  const size_t MN = (size_t)M * N;
  split_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<float*>(y), M, N, splits);
  return (int)cudaGetLastError();
}
