// Single-query (decode) GQA attention straight over a vector-quantized KV
// cache, with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_decode_kvq_kernel` /
// `flash_decode_kvq_pallas` (src/repro/kernels/flash_decode/kernel.py:73
// and :128). The wrapper builds, as the reference wrapper does in plain
// jnp, the query / K-codebook table qd (B, Hk, g, R*G, 256) fp32 =
// (q . cb_k) / sqrt(hd) and fp32 scales. Per position p the kernel reads
// the uint8 rows k_idx/v_idx (B, S, Hk, R*G) and the scales k_s/v_s
// (B, S, Hk), and computes
//   score_h(p) = k_s[p] * sum_j qd[h][j][k_idx[p][j]]
//   vhat(p)[c] = v_s[p] * sum_r cb_v[r][v_idx[p][r*G + c/vd]][c % vd]
// masks positions at or past lengths[b] with -1e30, folds them into an
// online softmax and divides by max(l, 1e-30), as the Pallas kernel does
// (kernel.py:97-125). Positions in [S, S_pad) stand for the reference
// wrapper's padding (zero indices, zero scales); they are reached only
// by a row whose length is <= 0 or > S.
//
// Bound on this card: bytes. A step reads, per (row, kv head), the qd
// slice (g * R*G * 1 KB), the 2 * R*G index bytes and two fp32 scales
// per position up to the length, and the V codebooks; at 512 positions
// the qd table outweighs the compressed cache.
//
// Design. One CTA per (kv head, batch row) serves the g query heads of
// the kv head, as the fp kernel does. The CTA first stages its qd slice
// (when it fits in shared memory; else the gathers read it through L2)
// and the V codebooks of its head. Eight warps split the positions into
// groups of four (warp w takes groups w, w+8, ...); a lane owns the
// index columns j = lane, lane+32 (a score is a warp-shuffle sum of the
// gathered table entries) and the hd/32 output channels lane*hd/32..,
// whose V values it rebuilds from the staged codebook rows. Each warp
// keeps its own fp32 (m, l, acc) per query head; the eight states are
// merged in warp order, so the reduction order is fixed and two runs are
// bitwise equal. The loop stops at the length. The table gathers are
// random 4-byte shared-memory reads, as in the fused VQ matmul's lookup;
// their bank conflicts are not avoided yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int GROUP = 4;    // positions per warp iteration
constexpr int E = 256;      // codebook entries per stage
constexpr int MAX_R = 2;    // residual stages
constexpr int MAX_JPL = 2;  // index columns per lane: R*G <= 64 at hd <= 128

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: output dtype; EPL = hd / 32 channels per lane; G >= g query heads;
// STAGED: the qd slice is in shared memory
template <typename T, int EPL, int G, bool STAGED>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kvq_kernel(const float* __restrict__ qd, const uint8_t* __restrict__ kidx,
                        const uint8_t* __restrict__ vidx, const float* __restrict__ ks,
                        const float* __restrict__ vs, const float* __restrict__ cbv,
                        const int* __restrict__ lengths, T* __restrict__ o, int S,
                        int S_pad, int H, int Hk, int g, int R, int RG, int vd) {
  constexpr int HD = 32 * EPL;
  extern __shared__ __align__(16) float smem[];
  const int tab = RG * E;  // floats of qd per query head
  float* cb_s = smem + (STAGED ? g * tab : 0);  // (R, E, vd)
  float* m_s = cb_s + R * E * vd;               // (WARPS, G)
  float* l_s = m_s + WARPS * G;                 // (WARPS, G)
  float* a_s = l_s + WARPS * G;                 // (WARPS, G, HD)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int L = lengths[b];
  const int n_pos = L > 0 ? min(L, S_pad) : S_pad;
  const int GR = RG / R;  // code groups per head

  const float* qsrc = qd + ((size_t)b * Hk + hk) * g * tab;
  const float* cbsrc = cbv + (size_t)hk * R * E * vd;
  for (int i = threadIdx.x; i < R * E * vd; i += WARPS * 32) cb_s[i] = cbsrc[i];
  if (STAGED) {
    const float4* src = reinterpret_cast<const float4*>(qsrc);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < g * tab / 4; i += WARPS * 32) dst[i] = src[i];
  }
  __syncthreads();
  const float* qtab = STAGED ? smem : qsrc;

  // the index bytes and codebook coordinates this lane reads
  int vcol[EPL][MAX_R], vcoord[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int c = lane * EPL + i;
    vcoord[i] = c % vd;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) vcol[i][r] = r * GR + c / vd;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -1e30f;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[h][i] = 0.f;
  }

  const size_t row = (size_t)Hk * RG;  // index bytes between positions
  const uint8_t* kb = kidx + (size_t)b * S * row + (size_t)hk * RG;
  const uint8_t* vb = vidx + (size_t)b * S * row + (size_t)hk * RG;
  const float* ksb = ks + (size_t)b * S * Hk + hk;
  const float* vsb = vs + (size_t)b * S * Hk + hk;

  for (int p0 = w * GROUP; p0 < n_pos; p0 += WARPS * GROUP) {
    int kcol[GROUP][MAX_JPL];
    float ksc[GROUP], vhat[GROUP][EPL];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int p = p0 + u;
      const bool real = p < n_pos && p < S;  // else: padding or past the range
      float vsc = 0.f;
      ksc[u] = 0.f;
#pragma unroll
      for (int jj = 0; jj < MAX_JPL; ++jj) {
        const int j = lane + 32 * jj;
        kcol[u][jj] = (real && j < RG) ? kb[(size_t)p * row + j] : 0;
      }
      if (real) {
        ksc[u] = ksb[(size_t)p * Hk];
        vsc = vsb[(size_t)p * Hk];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          if (r < R) {
            const int e = real ? vb[(size_t)p * row + vcol[i][r]] : 0;
            sum += cb_s[(r * E + e) * vd + vcoord[i]];
          }
        }
        vhat[u][i] = sum * vsc;
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
      const float* qh = qtab + (size_t)h * tab;
      float s[GROUP];
      float s_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < MAX_JPL; ++jj) {
          const int j = lane + 32 * jj;
          if (j < RG) part += qh[j * E + kcol[u][jj]];
        }
        const float d = warp_sum(part) * ksc[u];
        const int p = p0 + u;
        // past the range: not a position at all; past the length: masked
        s[u] = p >= n_pos ? -INFINITY : (p < L ? d : -1e30f);
        s_max = fmaxf(s_max, s[u]);
      }
      const float m_new = fmaxf(m[h], s_max);
      const float corr = expf(m[h] - m_new);
      float psum = 0.f;
      float pv[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) pv[i] = 0.f;
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const float pu = expf(s[u] - m_new);
        psum += pu;
#pragma unroll
        for (int i = 0; i < EPL; ++i) pv[i] = fmaf(pu, vhat[u][i], pv[i]);
      }
      l[h] = l[h] * corr + psum;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[h][i] = acc[h][i] * corr + pv[i];
      m[h] = m_new;
    }
  }

  // merge the warp states in warp order
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < g) {
      if (lane == 0) {
        m_s[w * G + h] = m[h];
        l_s[w * G + h] = l[h];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) a_s[(w * G + h) * HD + lane * EPL + i] = acc[h][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * HD; e += WARPS * 32) {
    const int h = e / HD;
    const int dch = e - h * HD;
    float mx = m_s[h];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) mx = fmaxf(mx, m_s[ww * G + h]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float f = expf(m_s[ww * G + h] - mx);
      lsum += l_s[ww * G + h] * f;
      asum += a_s[(ww * G + h) * HD + dch] * f;
    }
    o[((size_t)b * H + (size_t)hk * g + h) * HD + dch] =
        from_f<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

constexpr size_t MAX_SMEM = 232448;  // 227 KB: the most a block may use

template <typename T, int EPL, int G, bool STAGED>
cudaError_t launch_k(const float* qd, const uint8_t* kidx, const uint8_t* vidx,
                     const float* ks, const float* vs, const float* cbv,
                     const int* lengths, void* o, int B, int S, int S_pad, int H,
                     int Hk, int R, int RG, int vd, size_t smem, cudaStream_t st) {
  auto kern = flash_decode_kvq_kernel<T, EPL, G, STAGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hk, B), WARPS * 32, smem, st>>>(qd, kidx, vidx, ks, vs, cbv, lengths,
                                              static_cast<T*>(o), S, S_pad, H, Hk,
                                              H / Hk, R, RG, vd);
  return cudaGetLastError();
}

template <typename T, int EPL, int G>
cudaError_t launch_s(const float* qd, const uint8_t* kidx, const uint8_t* vidx,
                     const float* ks, const float* vs, const float* cbv,
                     const int* lengths, void* o, int B, int S, int S_pad, int H,
                     int Hk, int R, int RG, int vd, cudaStream_t st) {
  const int g = H / Hk;
  const size_t tail = ((size_t)R * E * vd + (size_t)WARPS * G * (2 + 32 * EPL)) * 4;
  const size_t staged = tail + (size_t)g * RG * E * 4;
  if (staged <= MAX_SMEM)
    return launch_k<T, EPL, G, true>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S,
                                     S_pad, H, Hk, R, RG, vd, staged, st);
  return launch_k<T, EPL, G, false>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S,
                                    S_pad, H, Hk, R, RG, vd, tail, st);
}

template <typename T, int EPL>
cudaError_t launch_g(const float* qd, const uint8_t* kidx, const uint8_t* vidx,
                     const float* ks, const float* vs, const float* cbv,
                     const int* lengths, void* o, int B, int S, int S_pad, int H,
                     int Hk, int R, int RG, int vd, cudaStream_t st) {
  const int g = H / Hk;
  if (g <= 1)
    return launch_s<T, EPL, 1>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
  if (g <= 2)
    return launch_s<T, EPL, 2>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
  if (g <= 4)
    return launch_s<T, EPL, 4>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
  if (g <= 8)
    return launch_s<T, EPL, 8>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const float* qd, const uint8_t* kidx, const uint8_t* vidx,
                     const float* ks, const float* vs, const float* cbv,
                     const int* lengths, void* o, int B, int S, int S_pad, int H,
                     int Hk, int hd, int R, int RG, int vd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_g<T, 1>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
    case 64: return launch_g<T, 2>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
    case 128: return launch_g<T, 4>(qd, kidx, vidx, ks, vs, cbv, lengths, o, B, S, S_pad, H, Hk, R, RG, vd, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qd (B, Hk, H/Hk, R*hd/vd, 256) f32; k_idx/v_idx (B, S, Hk, R*hd/vd) u8;
// k_s/v_s (B, S, Hk) f32; cb_v (Hk, R, 256, vd) f32; lengths (B,) i32;
// o (B, H, hd) bf16 (is_bf16 = 1) or f32. S_pad >= S: see above.
extern "C" int flash_decode_kvq_launch(const void* qd, const void* k_idx,
                                       const void* v_idx, const void* k_s,
                                       const void* v_s, const void* cb_v,
                                       const void* lengths, void* o, int B, int S,
                                       int S_pad, int H, int Hk, int hd, int R,
                                       int vd, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || S_pad < S || Hk < 1 || H % Hk != 0 || R < 1 || R > MAX_R ||
      vd < 1 || hd % vd != 0 || R * (hd / vd) > 32 * MAX_JPL)
    return (int)cudaErrorInvalidValue;
  const int RG = R * (hd / vd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(qd);
  const uint8_t* kp = static_cast<const uint8_t*>(k_idx);
  const uint8_t* vp = static_cast<const uint8_t*>(v_idx);
  const float* ksp = static_cast<const float*>(k_s);
  const float* vsp = static_cast<const float*>(v_s);
  const float* cbp = static_cast<const float*>(cb_v);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(qp, kp, vp, ksp, vsp, cbp, len, o, B, S, S_pad, H,
                                        Hk, hd, R, RG, vd, st)
              : launch_t<float>(qp, kp, vp, ksp, vsp, cbp, len, o, B, S, S_pad, H, Hk, hd,
                                R, RG, vd, st);
  return (int)err;
}
