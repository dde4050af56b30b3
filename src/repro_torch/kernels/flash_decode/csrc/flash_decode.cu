// Single-query (decode) GQA attention over a contiguous fp KV cache, with
// an online softmax (flash-decoding), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_decode_kernel` /
// `flash_decode_pallas` (src/repro/kernels/flash_decode/kernel.py:33 and
// :183): q (B, H, hd), k/v (B, S, Hk, hd) in the model dtype (bf16 or
// fp32), lengths (B,) int32 -> o (B, H, hd) in q's dtype. Positions at or
// past lengths[b] are masked with -1e30 and the result is acc / max(l,
// 1e-30), as in the Pallas kernel (kernel.py:54-70).
//
// Bound on this card: bytes. Each step reads every cached K and V row once
// (B * len * 2 * Hk * hd * itemsize) and does 4 flops per element.
//
// Design. One CTA per (kv head, batch row) serves the g = H/Hk query heads
// that share the kv head. Its eight warps split the sequence into groups of
// four positions (warp w takes groups w, w+8, ...); a lane holds hd/32
// channels, so a K or V row is one coalesced vector load per lane and a
// score is a warp-shuffle reduction. Each warp keeps its own fp32
// online-softmax state (m, l, acc) per query head and updates it once per
// group of four; the eight states are merged in warp order at the end, so
// the reduction order is fixed and two runs are bitwise equal.
// The loop stops after ceil(min(len, S) / 4) groups: positions past the
// length are masked anyway, and this is the byte saving that matters at
// short lengths. lengths[b] <= 0 attends over all S masked positions,
// which is what the Pallas kernel computes there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int GROUP = 4;  // positions per warp iteration

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// EPL contiguous elements -> fp32, with one vector load where it fits
template <typename T, int EPL>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[EPL]) {
  constexpr int BYTES = EPL * (int)sizeof(T);
  alignas(16) T tmp[EPL];
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(tmp)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(tmp) = *reinterpret_cast<const uint32_t*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) tmp[i] = p[i];
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) out[i] = to_f(tmp[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: cache/query dtype; EPL = hd / 32 channels per lane; G >= g heads
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, int S, int H, int Hk, int g,
                    float sm_scale) {
  constexpr int HD = 32 * EPL;
  __shared__ float m_s[WARPS][G];
  __shared__ float l_s[WARPS][G];
  __shared__ float a_s[WARPS][G][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int L = lengths[b];
  const int n_pos = L > 0 ? min(L, S) : S;

  float qf[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < g) {
      load_f32<T, EPL>(q + ((size_t)b * H + (size_t)hk * g + h) * HD + lane * EPL, qf[h]);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qf[h][i] = 0.f;
    }
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -1e30f;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[h][i] = 0.f;
  }

  const size_t row = (size_t)Hk * HD;  // elements between positions
  const T* kb = k + (size_t)b * S * row + (size_t)hk * HD + lane * EPL;
  const T* vb = v + (size_t)b * S * row + (size_t)hk * HD + lane * EPL;

  for (int p0 = w * GROUP; p0 < n_pos; p0 += WARPS * GROUP) {
    float kf[GROUP][EPL], vf[GROUP][EPL];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int p = p0 + u;
      if (p < n_pos) {
        load_f32<T, EPL>(kb + (size_t)p * row, kf[u]);
        load_f32<T, EPL>(vb + (size_t)p * row, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) { kf[u][i] = 0.f; vf[u][i] = 0.f; }
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
      float s[GROUP];
      float s_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) d = fmaf(qf[h][i], kf[u][i], d);
        d = warp_sum(d) * sm_scale;
        const int p = p0 + u;
        // past the array: not a position at all; past the length: masked
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
        for (int i = 0; i < EPL; ++i) pv[i] = fmaf(pu, vf[u][i], pv[i]);
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
      if (lane == 0) { m_s[w][h] = m[h]; l_s[w][h] = l[h]; }
#pragma unroll
      for (int i = 0; i < EPL; ++i) a_s[w][h][lane * EPL + i] = acc[h][i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * HD; e += WARPS * 32) {
    const int h = e / HD;
    const int dch = e - h * HD;
    float mx = m_s[0][h];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) mx = fmaxf(mx, m_s[ww][h]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float f = expf(m_s[ww][h] - mx);
      lsum += l_s[ww][h] * f;
      asum += a_s[ww][h][dch] * f;
    }
    o[((size_t)b * H + (size_t)hk * g + h) * HD + dch] =
        from_f<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int EPL>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int S, int H, int Hk,
                     cudaStream_t st) {
  const int g = H / Hk;
  const float sm_scale = 1.0f / sqrtf((float)(32 * EPL));
  dim3 grid(Hk, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (g <= 1)
    flash_decode_kernel<T, EPL, 1><<<grid, WARPS * 32, 0, st>>>(qp, kp, vp, lengths, op, S, H, Hk, g, sm_scale);
  else if (g <= 2)
    flash_decode_kernel<T, EPL, 2><<<grid, WARPS * 32, 0, st>>>(qp, kp, vp, lengths, op, S, H, Hk, g, sm_scale);
  else if (g <= 4)
    flash_decode_kernel<T, EPL, 4><<<grid, WARPS * 32, 0, st>>>(qp, kp, vp, lengths, op, S, H, Hk, g, sm_scale);
  else if (g <= 8)
    flash_decode_kernel<T, EPL, 8><<<grid, WARPS * 32, 0, st>>>(qp, kp, vp, lengths, op, S, H, Hk, g, sm_scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int S, int H, int Hk,
                     int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_g<T, 1>(q, k, v, lengths, o, B, S, H, Hk, st);
    case 64: return launch_g<T, 2>(q, k, v, lengths, o, B, S, H, Hk, st);
    case 128: return launch_g<T, 4>(q, k, v, lengths, o, B, S, H, Hk, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 q/k/v/o, 0 for float32
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* o, int B, int S,
                                   int H, int Hk, int hd, int is_bf16,
                                   void* stream) {
  if (B < 1 || S < 1 || Hk < 1 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  cudaError_t err = is_bf16
      ? launch_t<__nv_bfloat16>(q, k, v, len, o, B, S, H, Hk, hd, st)
      : launch_t<float>(q, k, v, len, o, B, S, H, Hk, hd, st);
  return (int)err;
}
