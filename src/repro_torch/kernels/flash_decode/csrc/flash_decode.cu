// Single-query (decode) GQA attention over a contiguous fp KV cache, split
// over the cache (flash-decoding), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_decode_kernel` /
// `flash_decode_pallas` (src/repro/kernels/flash_decode/kernel.py:33 and
// :183): q (B, H, hd), k/v (B, S, Hk, hd) in the model dtype (bf16 or
// fp32), lengths (B,) int32 -> o (B, H, hd) in q's dtype. Positions at or
// past lengths[b] are masked with -1e30 and the result is acc / max(l,
// 1e-30), as in the Pallas kernel (kernel.py:54-70); lengths[b] <= 0
// attends over all S masked positions, which is what the Pallas kernel
// computes there.
//
// Bound on this card: bytes. A step reads every cached K and V row up to
// the length once (B * len * 2 * Hk * hd * itemsize) and does 4 flops per
// element: ~0.004 ms for llama2-7b's 32 heads x 4 rows at lengths
// 1/512/200/64 in bf16, ~0.010 ms with all four rows at 512, at 3.35 TB/s.
//
// Design. One CTA per (row, kv head) walking the whole row is latency-
// bound: the longest row takes many dependent rounds while short rows
// leave their SMs idle. So:
//  * Split over S. The grid is (kv head, row, split); a CTA takes CHUNK =
//    64 positions of one row (the split count comes from the host-known
//    S). A CTA whose chunk starts at or past its row's walked length
//    exits at once and writes nothing; the merge reads only the splits
//    below that length, so it never sees one.
//  * Every load in flight before any arithmetic. A row of hd elements is
//    read by LPR lanes with one 16-byte load each; the 256 threads take
//    the chunk's rows in passes of 256 / LPR, so each thread issues all
//    of its K and V loads (CHUNK * LPR / 256 of each) up front: 32 KB in
//    flight per CTA for bf16 hd=128.
//  * One load serves the GQA group: the g <= 8 query heads of the kv
//    head are scored against each loaded row (a shuffle reduction over
//    the row's LPR lanes). The scores go to shared memory, warp h takes
//    head h's softmax over the chunk (max and sum by butterfly
//    shuffles), and each thread folds its rows' V into (g, its channels)
//    with the resulting weights; the row passes are summed by shuffles
//    within a warp and in warp order across warps, into the chunk's
//    (m, l, acc[hd]) fp32 partial.
//  * A second kernel merges a (row, head)'s partials in split order, so
//    two runs are bitwise equal (no atomics, no counters).
//
// Paged entry (`flash_decode_paged_kernel`, for `flash_decode_paged`,
// which replaces the reference's gather + `flash_decode_pallas`,
// src/repro/kernels/flash_decode/ops.py:61): k/v are block arenas (NB,
// bs, Hk, hd) and a (B, W) int32 block table gives each row's blocks; the
// cache is S = W * bs positions long, and position p of row b is arena row
// clamp(table[b, p / bs], 0, NB - 1) * bs + p % bs (the reference's clip
// gather: the sentinel NB reads block NB - 1, which the mask hides). Only
// the row address differs from the contiguous kernel (one table read per
// row a thread loads, 4 blocks per 64-position chunk at bs = 16), so a
// paged launch equals the contiguous kernel over the gathered view bit for
// bit, and no view is gathered.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cache_rows.cuh"

namespace {

constexpr int CHUNK = 64;  // positions per CTA: ops.py FD_CHUNK
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // also the most query heads per kv head

__device__ __forceinline__ void to_f32(const uint4& w, float (&out)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_f32(const uint4& w, float (&out)[4], float) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the row's walked length: its length, or all S positions when it is <= 0
__device__ __forceinline__ int walked(int L, int S) { return L > 0 ? min(L, S) : S; }

// T: cache/query dtype; HD: head dim; G >= g query heads per kv head;
// Cache: ContiguousRows or PagedRows (cache_rows.cuh). S: the cache's
// positions.
// Partials: part_acc[((b*H + h) * splits + split) * HD + c], part_ml[(b*H
// + h) * splits + split] = (m, l).
template <typename T, int HD, int G, typename Cache>
__device__ __forceinline__ void
flash_decode_body(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ part_acc, float2* __restrict__ part_ml, Cache cache,
                  int S, int H, int Hk, float sm_scale) {
  constexpr int EPL = 16 / (int)sizeof(T);  // elements per 16-byte load
  constexpr int LPR = HD / EPL;             // lanes per row
  constexpr int RPP = THREADS / LPR;        // rows per pass
  constexpr int PPT = CHUNK / RPP;          // rows per thread
  static_assert(LPR >= 4 && LPR <= 32 && PPT >= 1 && CHUNK % RPP == 0, "shape");
  __shared__ float s_sm[G][CHUNK];          // scores, then weights
  __shared__ float red[WARPS][G][HD];       // each warp's sum of its rows
  __shared__ float2 ml_sm[G];

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int g = H / Hk;
  const int L = lengths[b];
  const int lo = split * CHUNK;
  const int np = min(CHUNK, walked(L, S) - lo);
  if (np <= 0) return;  // past the walked length: the merge stops before it

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = tid % LPR, r0 = tid / LPR;
  const size_t row = (size_t)Hk * HD;  // elements between positions
  const size_t col = (size_t)hk * HD + c * EPL;

  // 1. all of this thread's K and V loads, then q
  size_t off[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)  // rows past np re-read row np - 1
    off[i] = cache.row(b, lo + min(r0 + i * RPP, np - 1)) * row + col;
  uint4 kr[PPT], vr[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) kr[i] = ld16(k + off[i]);
#pragma unroll
  for (int i = 0; i < PPT; ++i) vr[i] = ld16(v + off[i]);
  const size_t head0 = (size_t)b * H + (size_t)hk * g;  // first query head
  float qf[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h < g) {
      to_f32(ld16(q + (head0 + h) * HD + c * EPL), qf[h], T());
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[h][e] = 0.f;
    }
  }

  // 2. scores: past np not a position at all (-inf); past the length
  // (only when L <= 0) masked with -1e30
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float kf[EPL];
    to_f32(kr[i], kf, T());
    const int p = r0 + i * RPP;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qf[h][e], kf[e], d);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (c == 0) s_sm[h][p] = p >= np ? -INFINITY : (lo + p < L ? d * sm_scale : -1e30f);
    }
  }
  __syncthreads();

  // 3. warp h: the chunk's softmax for head h
  if (w < g) {
    const float s0 = s_sm[w][lane], s1 = s_sm[w][lane + 32];
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p0 = expf(s0 - m), p1 = expf(s1 - m);
    s_sm[w][lane] = p0;
    s_sm[w][lane + 32] = p1;
    float l = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) ml_sm[w] = make_float2(m, l);
  }
  __syncthreads();

  // 4. the weighted V rows: this thread's rows in order, then the warp's
  // row slots by a butterfly, then the warps in order
  float vf[PPT][EPL];
#pragma unroll
  for (int i = 0; i < PPT; ++i) to_f32(vr[i], vf[i], T());
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h >= g) continue;
    float acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float p = s_sm[h][r0 + i * RPP];  // 0 past np
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[i][e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) red[w][h][c * EPL + e] = acc[e];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += THREADS) {
    const int h = i / HD, ch = i - h * HD;
    float a = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) a += red[ww][h][ch];
    part_acc[((head0 + h) * splits + split) * HD + ch] = a;
    if (ch == 0) part_ml[(head0 + h) * splits + split] = ml_sm[h];
  }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float2* __restrict__ part_ml, int S,
                    int H, int Hk, float sm_scale) {
  flash_decode_body<T, HD, G>(q, k, v, lengths, part_acc, part_ml, ContiguousRows{S}, S, H, Hk,
                              sm_scale);
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ table,
                          const int* __restrict__ lengths, float* __restrict__ part_acc,
                          float2* __restrict__ part_ml, int W, int bs, int NB, int H, int Hk,
                          float sm_scale) {
  flash_decode_body<T, HD, G>(q, k, v, lengths, part_acc, part_ml, PagedRows{table, W, bs, NB},
                              W * bs, H, Hk, sm_scale);
}

// o[b, h, :] = sum_s acc_s f_s / max(sum_s l_s f_s, 1e-30), f_s =
// exp(m_s - max m), over the row's live splits in order; one CTA per (row,
// head)
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_acc,
                                          const float2* __restrict__ part_ml,
                                          const int* __restrict__ lengths, T* __restrict__ o,
                                          int S, int H, int hd, int splits) {
  const size_t bh = blockIdx.x;
  const int live = (walked(lengths[bh / H], S) + CHUNK - 1) / CHUNK;
  const float2* ml = part_ml + bh * splits;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, ml[s].x);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(ml[s].x - mx);
      lsum += ml[s].y * f;
      asum += part_acc[(bh * splits + s) * hd + c] * f;
    }
    const float val = asum / fmaxf(lsum, 1e-30f);
    if constexpr (sizeof(T) == 2)
      o[bh * hd + c] = __float2bfloat16(val);
    else
      o[bh * hd + c] = val;
  }
}

// One launch's operands; table is null for the contiguous cache.
struct Args {
  const void *q, *k, *v;
  const int *table, *lengths;
  void* o;
  float* part_acc;
  float2* part_ml;
  int B, S, W, bs, NB, H, Hk;
};

template <typename T, int HD, int G>
cudaError_t launch_k(const Args& a, cudaStream_t st) {
  const int splits = (a.S + CHUNK - 1) / CHUNK;
  dim3 grid(a.Hk, a.B, splits);
  const float scale = 1.0f / sqrtf((float)HD);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  if (a.table)
    flash_decode_paged_kernel<T, HD, G><<<grid, THREADS, 0, st>>>(
        q, k, v, a.table, a.lengths, a.part_acc, a.part_ml, a.W, a.bs, a.NB, a.H, a.Hk, scale);
  else
    flash_decode_kernel<T, HD, G><<<grid, THREADS, 0, st>>>(
        q, k, v, a.lengths, a.part_acc, a.part_ml, a.S, a.H, a.Hk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T><<<(unsigned)(a.B * a.H), HD < 128 ? HD : 128, 0, st>>>(
      a.part_acc, a.part_ml, a.lengths, static_cast<T*>(a.o), a.S, a.H, HD, splits);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  const int g = a.H / a.Hk;
  if (g <= 1) return launch_k<T, HD, 1>(a, st);
  if (g <= 2) return launch_k<T, HD, 2>(a, st);
  if (g <= 4) return launch_k<T, HD, 4>(a, st);
  if (g <= 8) return launch_k<T, HD, 8>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(const Args& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_g<T, 32>(a, st);
    case 64: return launch_g<T, 64>(a, st);
    case 128: return launch_g<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

int launch(Args a, int hd, int chunk, int is_bf16, void* ws, void* stream) {
  if (a.B < 1 || a.S < 1 || a.Hk < 1 || a.H % a.Hk != 0 || a.H / a.Hk > WARPS ||
      chunk != CHUNK)
    return (int)cudaErrorInvalidValue;
  const size_t heads = (size_t)a.B * a.H * ((a.S + CHUNK - 1) / CHUNK);
  a.part_acc = static_cast<float*>(ws);
  a.part_ml = reinterpret_cast<float2*>(a.part_acc + heads * hd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_t<__nv_bfloat16>(a, hd, st) : launch_t<float>(a, hd, st));
}

}  // namespace

// q (B, H, hd), k/v (B, S, Hk, hd), o (B, H, hd): bfloat16 (is_bf16 = 1)
// or float32, contiguous, 16-byte aligned; lengths (B,) int32; ws a fp32
// workspace of B * H * splits * (hd + 2) floats, splits = ceil(S /
// chunk); chunk must be CHUNK (the wrapper's FD_CHUNK).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* o, void* ws, int B, int S,
                                   int H, int Hk, int hd, int chunk, int is_bf16,
                                   void* stream) {
  Args a{q, k, v, nullptr, static_cast<const int*>(lengths), o, nullptr, nullptr,
         B, S, 0, 0, 0, H, Hk};
  return launch(a, hd, chunk, is_bf16, ws, stream);
}

// As flash_decode_launch, k/v being arenas (NB, bs, Hk, hd) read through
// table (B, W) int32, contiguous; the cache is S = W * bs positions long.
extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const void* table, const void* lengths, void* o,
                                         void* ws, int B, int NB, int bs, int W, int H, int Hk,
                                         int hd, int chunk, int is_bf16, void* stream) {
  if (NB < 1 || bs < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(table), static_cast<const int*>(lengths), o,
         nullptr, nullptr, B, W * bs, W, bs, NB, H, Hk};
  return launch(a, hd, chunk, is_bf16, ws, stream);
}
