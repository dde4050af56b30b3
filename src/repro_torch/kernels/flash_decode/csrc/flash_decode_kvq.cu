// Single-query (decode) GQA attention straight over a vector-quantized KV
// cache, split over the cache (flash-decoding), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_decode_kvq_kernel` /
// `flash_decode_kvq_pallas` (src/repro/kernels/flash_decode/kernel.py:73
// and :128) and the table its wrapper builds in plain jnp
// (src/repro/kernels/flash_decode/ops.py:134). Per position p the kernel
// reads the uint8 rows k_idx/v_idx (B, S, Hk, R*G) and the scales k_s/v_s
// (B, S, Hk) as the cache holds them (bf16 or fp32), and computes
//   qd_h[j][e] = (q_h . cb_k[r, e, :]) / sqrt(hd)     (j = r*G + group)
//   score_h(p) = k_s[p] * sum_j qd_h[j][k_idx[p][j]]
//   vhat(p)[c] = v_s[p] * sum_r cb_v[r][v_idx[p][r*G + c/vd]][c % vd]
// masks positions at or past lengths[b] with -1e30, folds them into an
// online softmax and divides by max(l, 1e-30), as the Pallas kernel does
// (kernel.py:97-125). Positions in [S, S_pad) stand for the reference
// wrapper's padding (zero indices, zero scales); they are reached only by
// a row whose length is <= 0 or > S.
//
// Bound on this card: bytes. A step reads q, the 2 * R*G index bytes and
// two scales per position up to the length, both codebooks and the
// lengths: ~3.5 MB for llama2-7b's 32 heads x 4 rows at the checked
// lengths (kv_bits=4), ~1 us at 3.35 TB/s.
//
// Design.
//  * Split over S. The grid is (kv head x head chunk, row, split); a CTA
//    takes `chunk` positions of one row (the split count comes from the
//    host-known S, so the launch needs no device read). A CTA whose chunk
//    starts at or past its row's walked length writes a neutral partial
//    (m = -inf, l = 0, acc = 0) and stops. A second kernel merges the
//    partials of a (row, head) in split order, so two runs are bitwise
//    equal (no atomics).
//  * The table in the CTA. Each CTA builds the qd table of its query
//    heads itself in shared memory, entry-major (h, e, j) with the row
//    padded to RGp, a multiple of 32 words: lane j gathers word
//    e * RGp + j, which always lies in bank j mod 32, so the random score
//    gathers never conflict. GQA groups are cut into head chunks of two
//    heads (one where two tables do not fit; grid axis 0).
//  * Index rows. The CTA's k/v index rows (RG contiguous bytes each,
//    stride Hk*RG) go to shared memory by cp.async (16 bytes where RG and
//    the base allow, else 4) issued first, so they land while the table is
//    built; the gathers then read shared memory.
//  * V codebook gathers. Lane l rebuilds channels l*EPL.., W = min(vd,
//    EPL) words at a time. The V codebook of each stage is replicated
//    into 32 / W slots, slot s holding the W-word chunk that lanes l = s
//    (mod 32 / W) read, so the lanes of one shared-memory wavefront (32 / W
//    lanes for a W-word load) read distinct banks whatever entries they
//    gather: R * 32 KB per CTA.
//  * Sixteen warps take groups of four positions of the chunk; each keeps
//    fp32 (m, l, acc) per query head, merged in warp order. The chunk is
//    long (256 positions): each CTA builds a 16K-entry table, and in the
//    decode step most rows end within one or two chunks.
//
// Paged entry (`flash_decode_kvq_paged_kernel`, for
// `flash_decode_kvq_paged`, which replaces the reference's gather +
// `flash_decode_kvq`, src/repro/kernels/flash_decode/ops.py:154): the
// index and scale leaves are block arenas (NB, bs, Hk, ...) and a (B, W)
// int32 block table gives each row's blocks (cache_rows.cuh); the cache is
// S = W * bs positions long. Only the addresses of the staged index rows
// and scales differ from the contiguous kernel (one table read per row,
// 16 blocks per 256-position chunk at bs = 16), so a paged launch equals
// the contiguous kernel over the gathered view bit for bit, and no view
// is gathered.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cache_rows.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int GROUP = 4;    // positions per warp iteration
constexpr int E = 256;      // codebook entries per stage
constexpr int MAX_R = 2;    // residual stages
constexpr int MAX_RG = 64;  // index columns per head: two per lane
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float ld_scale(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int W> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_vec(float* a, float v) { a[0] += v; }
__device__ __forceinline__ void add_vec(float* a, float2 v) { a[0] += v.x; a[1] += v.y; }
__device__ __forceinline__ void add_vec(float* a, float4 v) {
  a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

struct Smem {  // float offsets of the CTA's shared-memory regions
  int rep, cbk, cbv, q, ks, vs, m, l, a, idx, total;
  __host__ __device__ Smem(int hc, int RGp, int R, int hd, int vd, int chunk, int RG) {
    rep = hc * E * RGp;            // qd table (hc, E, RGp) first
    cbk = rep + R * E * 32;        // V codebook replicas (R, E, 32 words)
    cbv = cbk + R * E * vd;        // the head's K and V codebooks
    q = cbv + R * E * vd;
    ks = q + hc * hd;              // the CTA's query rows, fp32
    vs = ks + chunk;
    m = vs + chunk;
    l = m + WARPS * hc;
    a = l + WARPS * hc;            // warp partials (WARPS, hc, hd)
    idx = a + WARPS * hc * hd;     // k, then v index rows (chunk, RG) bytes
    idx = (idx + 3) & ~3;
    total = idx + (2 * chunk * RG + 3) / 4;
  }
};

// EPL = hd / 32 channels per lane; W = min(vd, EPL) words per V gather;
// HMAX >= query heads per CTA; R residual stages (a template argument, so
// the gathers of a group of positions share one basic block); Cache:
// ContiguousRows or PagedRows (cache_rows.cuh), S the cache's positions
template <int EPL, int W, int HMAX, int R, typename Cache>
__device__ __forceinline__ void
flash_decode_kvq_body(const void* __restrict__ q, const uint8_t* __restrict__ kidx,
                      const uint8_t* __restrict__ vidx, const void* __restrict__ ks,
                      const void* __restrict__ vs, const float* __restrict__ cbk,
                      const float* __restrict__ cbv, const int* __restrict__ lengths,
                      float* __restrict__ part_acc, float2* __restrict__ part_ml, Cache cache,
                      int S, int S_pad, int H, int Hk, int vd, int chunk, int hc_per,
                      int q_bf16, int s_bf16, int idx_vec) {
  constexpr int HD = 32 * EPL;
  constexpr int SLOTS = 32 / W;
  extern __shared__ __align__(16) float smem[];
  const int g = H / Hk;
  const int n_hc = (g + hc_per - 1) / hc_per;
  const int hk = blockIdx.x / n_hc;
  const int h0 = (blockIdx.x - hk * n_hc) * hc_per;
  const int hc = min(hc_per, g - h0);
  const int b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int G = HD / vd, RG = R * G;
  const int RGp = (RG + 31) & ~31;
  const Smem L(hc_per, RGp, R, HD, vd, chunk, RG);
  const int len = lengths[b];
  const int n_pos = len > 0 ? min(len, S_pad) : S_pad;
  const int lo = split * chunk;
  const int np = min(chunk, n_pos - lo);
  const size_t head0 = (size_t)b * H + (size_t)hk * g + h0;  // first query head

  if (np <= 0) {  // past the walked length: a neutral partial
    for (int i = threadIdx.x; i < hc * HD; i += WARPS * 32) {
      const int h = i / HD;
      part_acc[((head0 + h) * splits + split) * HD + i - h * HD] = 0.f;
      if (i - h * HD == 0) part_ml[(head0 + h) * splits + split] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  float* qtab = smem;
  float* rep = smem + L.rep;
  float* qs = smem + L.q;
  float* ks_s = smem + L.ks;
  float* vs_s = smem + L.vs;
  uint8_t* kid_s = reinterpret_cast<uint8_t*>(smem + L.idx);
  uint8_t* vid_s = kid_s + chunk * RG;

  // 1. index rows of the real positions, asynchronously; padding rows are 0
  const size_t row = (size_t)Hk * RG;  // index bytes between positions
  const int n_real = max(0, min(np, S - lo));
  const size_t col = (size_t)hk * RG;
  const int per_row = RG / idx_vec;
  for (int i = threadIdx.x; i < 2 * n_real * per_row; i += WARPS * 32) {
    const int kv = i / (n_real * per_row);
    const int r = i - kv * n_real * per_row;
    const int p = r / per_row, c = (r - p * per_row) * idx_vec;
    cp_async((kv ? vid_s : kid_s) + p * RG + c,
             (kv ? vidx : kidx) + cache.row(b, lo + p) * row + col + c, idx_vec);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = n_real * RG + threadIdx.x; i < np * RG; i += WARPS * 32) {
    kid_s[i] = 0;
    vid_s[i] = 0;
  }
  for (int p = threadIdx.x; p < np; p += WARPS * 32) {
    const bool real = lo + p < S;
    const size_t si = real ? cache.row(b, lo + p) * Hk + hk : 0;
    ks_s[p] = real ? ld_scale(ks, si, s_bf16) : 0.f;
    vs_s[p] = real ? ld_scale(vs, si, s_bf16) : 0.f;
  }
  for (int i = threadIdx.x; i < hc * HD; i += WARPS * 32)
    qs[i] = ld_scale(q, head0 * HD + i, q_bf16);
  float* cbk_s = smem + L.cbk;
  float* cbv_s = smem + L.cbv;
  const size_t cb0 = (size_t)hk * R * E * vd;
  for (int i = threadIdx.x; i < R * E * vd; i += WARPS * 32) {
    cbk_s[i] = cbk[cb0 + i];
    cbv_s[i] = cbv[cb0 + i];
  }
  __syncthreads();  // q and codebooks staged

  // 2. the qd table of the CTA's heads, entry-major: thread t fills column
  // j = t % RGp of every (256 / RGp)-th entry row; and the V codebook
  // replicas, slot s holding chunk ((s * EPL) % vd) / W of each entry
  const float inv = 1.f / sqrtf((float)HD);
  {
    // four entries per iteration, their loads first: the loop is
    // latency-bound otherwise
    const int j = threadIdx.x % RGp, e0 = threadIdx.x / RGp;
    const int estep = WARPS * 32 / RGp;  // E / estep is a multiple of 4
    if (j < RG) {
      const int r = j / G, grp = j - r * G;
      for (int h = 0; h < hc; ++h) {
        float qv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) qv[c] = c < vd ? qs[h * HD + grp * vd + c] : 0.f;
        float* col = qtab + h * E * RGp + j;
        for (int e = e0; e < E; e += 4 * estep) {
          float d[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* ce = cbk_s + (r * E + e + u * estep) * vd;
            d[u] = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (c < vd) d[u] = fmaf(qv[c], ce[c], d[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) col[(e + u * estep) * RGp] = d[u] * inv;
        }
      }
    }
    const int word = threadIdx.x & 31, sl = word / W;
    const int off = ((sl * EPL) % vd) + (word - sl * W);
#pragma unroll 4
    for (int re = threadIdx.x >> 5; re < R * E; re += WARPS)
      rep[re * 32 + word] = cbv_s[re * vd + off];
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. the positions: warp w takes groups w, w + 8, ...
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int vcol[EPL / W];  // index column (stage 0) of each W-word gather
#pragma unroll
  for (int u = 0; u < EPL / W; ++u) vcol[u] = (lane * EPL + u * W) / vd;
  const int slot = lane % SLOTS;

  float m[HMAX], l[HMAX], acc[HMAX][EPL];
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[h][i] = 0.f;
  }

  for (int p0 = w * GROUP; p0 < np; p0 += WARPS * GROUP) {
    int kcol[GROUP][2];
    float ksc[GROUP], vhat[GROUP][EPL];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int p = min(p0 + u, np - 1);  // past np: masked below
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        kcol[u][jj] = j < RG ? kid_s[p * RG + j] : 0;
      }
      ksc[u] = ks_s[p];
      float v[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) v[i] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < EPL / W; ++c) {
          const int e = vid_s[p * RG + r * G + vcol[c]];
          add_vec(v + c * W, *reinterpret_cast<const typename Vec<W>::T*>(
                                 rep + ((r * E + e) * 32 + slot * W)));
        }
      }
      const float vsc = vs_s[p];
#pragma unroll
      for (int i = 0; i < EPL; ++i) vhat[u][i] = v[i] * vsc;
    }
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      if (h >= hc) continue;
      const float* qh = qtab + h * E * RGp;
      float s[GROUP];
      float s_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = lane + 32 * jj;
          if (j < RG) part += qh[kcol[u][jj] * RGp + j];
        }
        const float d = warp_sum(part) * ksc[u];
        const int p = lo + p0 + u;
        // past the range: not a position at all; past the length: masked
        s[u] = p0 + u >= np ? -INFINITY : (p < len ? d : -1e30f);
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

  // 4. merge the warp states in warp order into the split's partial
  float* m_s = smem + L.m;
  float* l_s = smem + L.l;
  float* a_s = smem + L.a;
#pragma unroll
  for (int h = 0; h < HMAX; ++h) {
    if (h < hc) {
      if (lane == 0) {
        m_s[w * hc_per + h] = m[h];
        l_s[w * hc_per + h] = l[h];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) a_s[(w * hc_per + h) * HD + lane * EPL + i] = acc[h][i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hc * HD; i += WARPS * 32) {
    const int h = i / HD;
    const int dch = i - h * HD;
    float mx = m_s[h];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) mx = fmaxf(mx, m_s[ww * hc_per + h]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float f = expf(m_s[ww * hc_per + h] - mx);  // 0 for an idle warp
      lsum += l_s[ww * hc_per + h] * f;
      asum += a_s[(ww * hc_per + h) * HD + dch] * f;
    }
    part_acc[((head0 + h) * splits + split) * HD + dch] = asum;
    if (dch == 0) part_ml[(head0 + h) * splits + split] = make_float2(mx, lsum);
  }
}

template <int EPL, int W, int HMAX, int R>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kvq_kernel(const void* __restrict__ q, const uint8_t* __restrict__ kidx,
                        const uint8_t* __restrict__ vidx, const void* __restrict__ ks,
                        const void* __restrict__ vs, const float* __restrict__ cbk,
                        const float* __restrict__ cbv, const int* __restrict__ lengths,
                        float* __restrict__ part_acc, float2* __restrict__ part_ml, int S,
                        int S_pad, int H, int Hk, int vd, int chunk, int hc_per,
                        int q_bf16, int s_bf16, int idx_vec) {
  flash_decode_kvq_body<EPL, W, HMAX, R>(q, kidx, vidx, ks, vs, cbk, cbv, lengths, part_acc,
                                         part_ml, ContiguousRows{S}, S, S_pad, H, Hk, vd,
                                         chunk, hc_per, q_bf16, s_bf16, idx_vec);
}

template <int EPL, int W, int HMAX, int R>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kvq_paged_kernel(const void* __restrict__ q, const uint8_t* __restrict__ kidx,
                              const uint8_t* __restrict__ vidx, const void* __restrict__ ks,
                              const void* __restrict__ vs, const float* __restrict__ cbk,
                              const float* __restrict__ cbv, const int* __restrict__ table,
                              const int* __restrict__ lengths, float* __restrict__ part_acc,
                              float2* __restrict__ part_ml, int Wt, int bs, int NB,
                              int S_pad, int H, int Hk, int vd, int chunk, int hc_per,
                              int q_bf16, int s_bf16, int idx_vec) {
  flash_decode_kvq_body<EPL, W, HMAX, R>(q, kidx, vidx, ks, vs, cbk, cbv, lengths, part_acc,
                                         part_ml, PagedRows{table, Wt, bs, NB}, Wt * bs,
                                         S_pad, H, Hk, vd, chunk, hc_per, q_bf16, s_bf16,
                                         idx_vec);
}

// o[b, h, :] = sum_s acc_s f_s / max(sum_s l_s f_s, 1e-30), f_s =
// exp(m_s - max m), over the splits in order; one CTA per (row, head)
template <typename T>
__global__ void kvq_merge_kernel(const float* __restrict__ part_acc,
                                 const float2* __restrict__ part_ml, T* __restrict__ o,
                                 int hd, int splits) {
  const size_t bh = blockIdx.x;
  const float2* ml = part_ml + bh * splits;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s].x);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float lsum = 0.f, asum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = expf(ml[s].x - mx);  // 0 for a neutral split
      lsum += ml[s].y * f;
      asum += part_acc[(bh * splits + s) * hd + c] * f;
    }
    const float v = asum / fmaxf(lsum, 1e-30f);
    if constexpr (sizeof(T) == 2)
      o[bh * hd + c] = __float2bfloat16(v);
    else
      o[bh * hd + c] = v;
  }
}

struct Args {
  const void *q, *ks, *vs;
  const uint8_t *kidx, *vidx;
  const float *cbk, *cbv;
  const int *table, *lengths;  // table: null for the contiguous cache
  float* part_acc;
  float2* part_ml;
  int B, S, Wt, bs, NB, S_pad, H, Hk, R, vd, chunk, splits, hc_per, q_bf16, s_bf16, idx_vec;
  size_t smem;
};

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's L1/shared memory as shared
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

template <int EPL, int W, int HMAX, int R>
cudaError_t launch_k(const Args& a, cudaStream_t st) {
  const int g = a.H / a.Hk;
  dim3 grid(a.Hk * ((g + a.hc_per - 1) / a.hc_per), a.B, a.splits);
  cudaError_t err;
  if (a.table) {
    auto kern = flash_decode_kvq_paged_kernel<EPL, W, HMAX, R>;
    if ((err = set_smem(kern, a.smem)) != cudaSuccess) return err;
    kern<<<grid, WARPS * 32, a.smem, st>>>(a.q, a.kidx, a.vidx, a.ks, a.vs, a.cbk, a.cbv,
                                           a.table, a.lengths, a.part_acc, a.part_ml, a.Wt,
                                           a.bs, a.NB, a.S_pad, a.H, a.Hk, a.vd, a.chunk,
                                           a.hc_per, a.q_bf16, a.s_bf16, a.idx_vec);
  } else {
    auto kern = flash_decode_kvq_kernel<EPL, W, HMAX, R>;
    if ((err = set_smem(kern, a.smem)) != cudaSuccess) return err;
    kern<<<grid, WARPS * 32, a.smem, st>>>(a.q, a.kidx, a.vidx, a.ks, a.vs, a.cbk, a.cbv,
                                           a.lengths, a.part_acc, a.part_ml, a.S, a.S_pad, a.H,
                                           a.Hk, a.vd, a.chunk, a.hc_per, a.q_bf16, a.s_bf16,
                                           a.idx_vec);
  }
  return cudaGetLastError();
}

template <int EPL, int W, int HMAX>
cudaError_t launch_r(const Args& a, cudaStream_t st) {
  return a.R == 1 ? launch_k<EPL, W, HMAX, 1>(a, st) : launch_k<EPL, W, HMAX, 2>(a, st);
}

template <int EPL, int W>
cudaError_t launch_h(const Args& a, cudaStream_t st) {
  return a.hc_per == 1 ? launch_r<EPL, W, 1>(a, st) : launch_r<EPL, W, 2>(a, st);
}

int launch(Args a, void* o, void* ws, int hd, int io_bf16, void* stream) {
  const int B = a.B, S = a.S, S_pad = a.S_pad, H = a.H, Hk = a.Hk, R = a.R, vd = a.vd;
  const int chunk = a.chunk;
  if (B < 1 || S < 1 || S_pad < S || Hk < 1 || H % Hk != 0 || H / Hk > 8 || R < 1 ||
      R > MAX_R || (vd != 2 && vd != 4 && vd != 8) || hd % vd != 0 ||
      R * (hd / vd) > MAX_RG || chunk < 1 || (hd != 32 && hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const int RG = R * (hd / vd);
  const uintptr_t al =
      reinterpret_cast<uintptr_t>(a.kidx) | reinterpret_cast<uintptr_t>(a.vidx);
  a.idx_vec = (RG % 16 == 0 && al % 16 == 0) ? 16 : 4;
  if (RG % 4 != 0 || al % 4 != 0) return (int)cudaErrorInvalidValue;
  a.splits = (S_pad + chunk - 1) / chunk;
  const size_t heads = (size_t)B * H * a.splits;
  a.part_acc = static_cast<float*>(ws);
  a.part_ml = reinterpret_cast<float2*>(a.part_acc + heads * hd);
  const int g = H / Hk, RGp = (RG + 31) & ~31;
  // two query heads a CTA where their tables fit, else one
  a.hc_per = g == 1 ? 1 : 2;
  a.smem = (size_t)Smem(a.hc_per, RGp, R, hd, vd, chunk, RG).total * 4;
  if (a.smem > MAX_SMEM && a.hc_per == 2) {
    a.hc_per = 1;
    a.smem = (size_t)Smem(1, RGp, R, hd, vd, chunk, RG).total * 4;
  }
  if (a.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epl = hd / 32, w = vd < epl ? vd : epl;
  cudaError_t err;
  if (epl == 1) err = launch_h<1, 1>(a, st);
  else if (epl == 2) err = launch_h<2, 2>(a, st);
  else if (w == 2) err = launch_h<4, 2>(a, st);
  else err = launch_h<4, 4>(a, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = hd < 128 ? hd : 128;
  if (io_bf16)
    kvq_merge_kernel<<<(unsigned)(B * H), threads, 0, st>>>(
        a.part_acc, a.part_ml, static_cast<__nv_bfloat16*>(o), hd, a.splits);
  else
    kvq_merge_kernel<<<(unsigned)(B * H), threads, 0, st>>>(a.part_acc, a.part_ml,
                                                           static_cast<float*>(o), hd, a.splits);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k_idx, const void* v_idx, const void* k_s,
               const void* v_s, const void* cb_k, const void* cb_v, const void* table,
               const void* lengths, int B, int S, int S_pad, int H, int Hk, int R, int vd,
               int chunk, int io_bf16, int s_bf16) {
  Args a{};
  a.q = q; a.ks = k_s; a.vs = v_s;
  a.kidx = static_cast<const uint8_t*>(k_idx);
  a.vidx = static_cast<const uint8_t*>(v_idx);
  a.cbk = static_cast<const float*>(cb_k);
  a.cbv = static_cast<const float*>(cb_v);
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.B = B; a.S = S; a.S_pad = S_pad; a.H = H; a.Hk = Hk; a.R = R; a.vd = vd;
  a.chunk = chunk; a.q_bf16 = io_bf16; a.s_bf16 = s_bf16;
  return a;
}

}  // namespace

// q (B, H, hd) bf16 (io_bf16 = 1) or fp32; k_idx/v_idx (B, S, Hk, R*hd/vd)
// u8; k_s/v_s (B, S, Hk) bf16 (s_bf16 = 1) or fp32; cb_k/cb_v (Hk, R,
// 256, vd) fp32; lengths (B,) i32; o (B, H, hd) in q's dtype; ws a fp32
// workspace of B*H*splits*(hd + 2) floats, splits = ceil(S_pad / chunk).
// S_pad >= S: see above.
extern "C" int flash_decode_kvq_launch(const void* q, const void* k_idx, const void* v_idx,
                                       const void* k_s, const void* v_s, const void* cb_k,
                                       const void* cb_v, const void* lengths, void* o,
                                       void* ws, int B, int S, int S_pad, int H, int Hk,
                                       int hd, int R, int vd, int chunk, int io_bf16,
                                       int s_bf16, void* stream) {
  Args a = make_args(q, k_idx, v_idx, k_s, v_s, cb_k, cb_v, nullptr, lengths, B, S, S_pad, H,
                     Hk, R, vd, chunk, io_bf16, s_bf16);
  return launch(a, o, ws, hd, io_bf16, stream);
}

// As flash_decode_kvq_launch, the index and scale leaves being arenas
// (NB, bs, Hk, ...) read through table (B, W) int32, contiguous; the cache
// is S = W * bs positions long.
extern "C" int flash_decode_kvq_paged_launch(
    const void* q, const void* k_idx, const void* v_idx, const void* k_s, const void* v_s,
    const void* cb_k, const void* cb_v, const void* table, const void* lengths, void* o,
    void* ws, int B, int NB, int bs, int W, int S_pad, int H, int Hk, int hd, int R, int vd,
    int chunk, int io_bf16, int s_bf16, void* stream) {
  if (NB < 1 || bs < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k_idx, v_idx, k_s, v_s, cb_k, cb_v, table, lengths, B, W * bs, S_pad,
                     H, Hk, R, vd, chunk, io_bf16, s_bf16);
  a.Wt = W; a.bs = bs; a.NB = NB;
  return launch(a, o, ws, hd, io_bf16, stream);
}
