// The EVA lookup, shared by fused_vq_matmul/csrc/fused_vq_matmul.cu (B1:
// the output codebook recomputed in the kernel from x and the codebooks)
// and oc_lookup/csrc/oc_lookup.cu (B5: the output codebook read from
// device memory, as vq_gemm.cu wrote it):
//
//   y[m, j] = scale[j] * sum_c sum_v O[c, m, v, I[c, v, j]]
//
// Bound on this card: bytes (the uint8 index matrix, 2 bits a weight at
// C = 2), but the fp32 gather has a floor of its own: every lookup reads
// mw*4 bytes of shared memory, 128 bytes a clock an SM, so at M = 4 a
// llama2-7b decode layer (202 M lookups) needs ~0.026 ms however it is
// laid out. The design keeps the gather at that rate:
//
//   * the paper's conflict-free lookup order: each lane owns one row v
//     of a slab of `VL` rows (its table) and a run of CPL columns; the
//     slab's O lives in shared memory entry-major, one 128-byte line per
//     (c, e) with the 32 (v, m) slots of that entry, the mw rows of M of
//     one v side by side (mw = 1, 2, 4 and VL * mw == 32). A lane reads
//     its mw values of entry e at word (c*256 + e)*32 + vl*mw, so the
//     bank group depends only on vl, and the 32/mw lanes of an access
//     phase hold distinct vl: no conflict, whatever the indices (the
//     TPU kernel gives each sublane row its own table the same way);
//   * one 4/8/16-byte load serves every row of M;
//   * indices in flight: each slab's index rows (C * VL rows of BN
//     bytes, each padded by 16 so lanes on different rows at one column
//     read distinct bank groups) and, for B1, its x rows are staged by
//     cp.async in a ring of `stages` tiles; the uint8 indices are read
//     as stored, never widened;
//   * B1 recomputes the slab's O (C*256*32 outputs of 8 FMAs) from the
//     staged x and the codebooks, transposed into shared memory once;
//     B5 loads the next slab's O into registers while the lookups of
//     this one run (16-byte loads, all issued together), and stores
//     them entry-major;
//   * the sums over v: per lane in registers (slab by slab, c inner),
//     then an xor butterfly over the VL lanes of a column group (each
//     step halves the values a lane holds), then over the CTAs of a
//     thread-block cluster (the V splits of one column tile) in rank
//     order through distributed shared memory, then, where one cluster
//     of <= 8 CTAs cannot fill the card, over clusters in order by a
//     second launch. No atomics: two runs are bitwise equal;
//   * two block barriers a slab (three with a single stage).
//
// What holds it back (chip_smoke.py breakdown, PERF.md): at M = 4 the
// shared-memory pipe, ~4.5 K clocks a slab: the gather's 16-byte loads,
// and for B1 as much again to recompute O (each thread reads its
// codebook columns from shared memory per entry); B5 instead re-reads
// the slab's O from L2 for every column tile. At M = 1 the index stream
// (the first slab lands 4-8 us after entry). Each call also pays ~3 us
// of cluster barriers and reduction.
//
// The tile model (BN, stages, cluster size, clusters per tile) is
// kernels/eva_lookup/tiles.py, which mirrors this file's layout.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#ifndef EVA_VARIANT
#define EVA_VARIANT 0
#endif

namespace eva {

namespace cg = cooperative_groups;

constexpr int THREADS = 512;            // one CTA an SM
constexpr int WARPS = THREADS / 32;
constexpr int KC = 256;                 // 2^n, n = 8
constexpr int D = 8;                    // VQ vector dimension
constexpr int LINE = 32;                // floats a (c, e) line: VL * MW
constexpr int MT = 4;                   // rows of M per CTA
constexpr int PAD = 16;                 // bytes after each staged index row
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block may use
constexpr int CS_MAX = 8;               // CTAs a cluster
constexpr int MAX_DEVICES = 64;

// Timing-only variants, built with -DEVA_VARIANT=k (kernels/build.py
// VARIANTS) for chip_smoke.py's breakdown phase; 0 is the kernel. Each
// removes one part of the work and computes a wrong y:
//   1 no_lookup:  add the index bytes themselves, no O read;
//   2 no_index:   hashed constant indices, no index loads;
//   3 no_o:       no output codebook in shared memory (B1: no
//                 recompute; B5: no load);
//   4 one_launch: each CTA writes its own partial sums to y: no cluster
//                 reduction and no second launch;
//   5 trace:      the kernel itself, with thread 0 of each CTA writing
//                 %globaltimer at entry, once slab 0 has landed, after the
//                 slab loop, after the first cluster barrier and at exit
//                 into trace[cta * 5 + k] (a right y); launched through an
//                 entry point of its own, `<kernel>_launch_traced`, so the
//                 served entry takes no timing arguments.
constexpr int kVariant = EVA_VARIANT;
constexpr int kNoLookup = 1, kNoIndex = 2, kNoO = 3, kOneLaunch = 4, kTrace = 5;

__device__ __forceinline__ void stamp(unsigned long long* trace, int k) {
  if constexpr (kVariant == kTrace) {
    if (threadIdx.x == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
      trace[cta * 5 + k] = ns;
    }
  }
}

struct Args {
  const float* x;          // B1: (M, V, D), 16-byte aligned
  const float* cb;         // B1: (C, D, KC)
  const float* O;          // B5: (C, M, V, KC), 16-byte aligned
  const uint8_t* idx;      // (C, V, N)
  const float* scale;      // (N,)
  float* y;                // (M, N)
  float* ws;               // (groups, M, N) when groups > 1
  unsigned long long* trace;  // the trace variant's timestamps (else unused)
  int M, V, N;
  int stages, cs, groups, slabs_per_split;
  int idx_aligned;         // N % 16 == 0 and idx 16-byte aligned
};

__host__ __device__ constexpr int vl_of(int mw) { return LINE / mw; }

template <int C, int MW, int BN, bool RECOMPUTE>
struct Layout {
  static constexpr int VL = vl_of(MW);
  static constexpr int CPL = BN / (WARPS * MW);       // columns a lane
  static constexpr int KEEP = CPL / VL;               // columns a lane after the butterfly
  static constexpr int PITCH = BN + PAD;
  static constexpr int IDX_STAGE = C * VL * PITCH;
  static constexpr int X_STAGE = RECOMPUTE ? MW * VL * D * 4 : 0;
  static constexpr int STAGE = IDX_STAGE + X_STAGE;
  static constexpr int O_BYTES = C * KC * LINE * 4;
  static constexpr int CB_BYTES = RECOMPUTE ? C * KC * D * 4 : 0;
  // shared memory: [codebooks (recompute only)] [O slab] [stages tiles]
  static constexpr int RING = CB_BYTES + O_BYTES;
  static_assert(CPL >= VL && CPL % 8 == 0, "column run too short");
  static_assert(MW * BN * 4 <= O_BYTES, "partials must fit the O slab");
  static size_t smem(int stages) { return (size_t)RING + (size_t)stages * STAGE; }
};

__device__ __forceinline__ uint32_t hashed_indices(int j, int v, int c) {
  uint32_t h = (uint32_t)j * 0x9E3779B1u ^ (uint32_t)v * 0x85EBCA77u ^
               (uint32_t)c * 0xC2B2AE3Du;
  h ^= h >> 15;
  return h * 0x2C1B3C6Du;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n groups are pending (n <= 3)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// the xor butterfly over the VL lanes of a column group: each step halves
// the values a lane holds (fixed order: every run sums alike)
template <int VL, int Q, int STEP>
__device__ __forceinline__ void butterfly(float (&v)[Q], int vl) {
  if constexpr ((VL >> (STEP + 1)) >= 1) {
    constexpr int O = VL >> (STEP + 1), HALF = Q >> (STEP + 1);
    const bool upper = (vl & O) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    butterfly<VL, Q, STEP + 1>(v, vl);
  }
}

// Where a CTA is: column tile blockIdx.x, V split blockIdx.y (cluster
// blockIdx.y / cs, rank blockIdx.y % cs), rows of M blockIdx.z * MT.
struct Tile {
  int j0, m0, mt, slab0, nslab, v_hi;
};

// stage slab s's index rows (and, recomputing, its x rows) into ring
// slot s % stages; one cp.async group whatever it holds
template <int C, int MW, int BN, bool RECOMPUTE>
__device__ __forceinline__ void issue_stage(const Args& a, const Tile& tl,
                                            unsigned char* ring, int s) {
  using L = Layout<C, MW, BN, RECOMPUTE>;
  constexpr int VL = L::VL, CH = BN / 16;
  const int t = threadIdx.x;
  if (s < tl.nslab) {
    unsigned char* st = ring + (s % a.stages) * L::STAGE;
    const int vbase = (tl.slab0 + s) * VL;
    if (kVariant != kNoIndex) {
      for (int q = t; q < C * VL * CH; q += THREADS) {
        const int ch = q % CH, row = q / CH;          // row = c * VL + r
        const int c = row / VL, v = vbase + row % VL, j = tl.j0 + ch * 16;
        if (v >= tl.v_hi || j >= a.N) continue;
        const uint8_t* src = a.idx + ((size_t)c * a.V + v) * a.N + j;
        unsigned char* dst = st + row * L::PITCH + ch * 16;
        if (a.idx_aligned) {
          cp_async16(dst, src);
        } else {
          for (int b = 0; b < 16 && j + b < a.N; ++b) dst[b] = src[b];
        }
      }
    }
    if constexpr (RECOMPUTE) {
      float* xs = reinterpret_cast<float*>(st + L::IDX_STAGE);  // (MW, VL, D)
      for (int q = t; q < MW * VL * 2; q += THREADS) {
        const int h = q & 1, r = (q >> 1) % VL, m = q / (2 * VL);
        const int v = vbase + r;
        float* dst = xs + (m * VL + r) * D + h * 4;
        if (m < tl.mt && v < tl.v_hi)
          cp_async16(dst, a.x + ((size_t)(tl.m0 + m) * a.V + v) * D + h * 4);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  cp_async_commit();
}

// B5: thread t's 16-byte pieces of slab s's O rows (row t % VL, entry
// quads t / VL + k * THREADS / VL), all loads in flight together
template <int C, int MW>
__device__ __forceinline__ void load_o(const Args& a, const Tile& tl, int s,
                                       float4 (&oreg)[C][4]) {
  constexpr int VL = vl_of(MW);
  const int t = threadIdx.x;
  const int v = (tl.slab0 + s) * VL + t % VL;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VL / 8; ++k) {
      const int quad = t / VL + k * (THREADS / VL);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kVariant != kNoO && m < tl.mt && v < tl.v_hi)
          f = __ldg(reinterpret_cast<const float4*>(
                    a.O + (((size_t)c * a.M + tl.m0 + m) * a.V + v) * KC) + quad);
        oreg[c][k * MW + m] = f;
      }
    }
}

template <int MW>
__device__ __forceinline__ void store_slot(float* p, float o0, float o1,
                                           float o2, float o3) {
  if constexpr (MW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o0, o1, o2, o3);
  } else if constexpr (MW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o0, o1);
  } else {
    *p = o0;
  }
}

// B1: slab s's O from its staged x rows and the transposed codebooks,
// into buffer Ob, entry-major (a quarter-warp's lanes on distinct rows:
// conflict-free stores)
template <int C, int MW, int BN>
__device__ __forceinline__ void recompute_o(const unsigned char* st,
                                            const float* cbT, float* Ob) {
  using L = Layout<C, MW, BN, true>;
  constexpr int VL = L::VL;
  const int t = threadIdx.x, r = t % VL;
  const float* xs = reinterpret_cast<const float*>(st + L::IDX_STAGE);
  float xr[MW][D];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int i = 0; i < D; ++i) xr[m][i] = xs[(m * VL + r) * D + i];
  constexpr int ESTEP = THREADS / VL;
#pragma unroll 2
  for (int k = 0; k < KC / ESTEP; ++k) {
    const int e = t / VL + k * ESTEP;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 b0 = reinterpret_cast<const float4*>(cbT)[(c * KC + e) * 2];
      const float4 b1 = reinterpret_cast<const float4*>(cbT)[(c * KC + e) * 2 + 1];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        float u = 0.f;
        u = fmaf(xr[m][0], b0.x, u);
        u = fmaf(xr[m][1], b0.y, u);
        u = fmaf(xr[m][2], b0.z, u);
        u = fmaf(xr[m][3], b0.w, u);
        u = fmaf(xr[m][4], b1.x, u);
        u = fmaf(xr[m][5], b1.y, u);
        u = fmaf(xr[m][6], b1.z, u);
        u = fmaf(xr[m][7], b1.w, u);
        o[m] = u;
      }
      store_slot<MW>(Ob + (c * KC + e) * LINE + r * MW, o[0], o[1], o[2], o[3]);
    }
  }
}

// B5: the O rows held in registers, into buffer Ob, entry-major
template <int C, int MW>
__device__ __forceinline__ void store_o(const float4 (&oreg)[C][4], float* Ob) {
  constexpr int VL = vl_of(MW);
  const int t = threadIdx.x, r = t % VL;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VL / 8; ++k) {
      const int quad = t / VL + k * (THREADS / VL);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float o0 = comp(oreg[c][k * MW], i);
        const float o1 = MW > 1 ? comp(oreg[c][k * MW + (MW > 1 ? 1 : 0)], i) : 0.f;
        const float o2 = MW > 2 ? comp(oreg[c][k * MW + (MW > 2 ? 2 : 0)], i) : 0.f;
        const float o3 = MW > 2 ? comp(oreg[c][k * MW + (MW > 2 ? 3 : 0)], i) : 0.f;
        store_slot<MW>(Ob + (c * KC + quad * 4 + i) * LINE + r * MW, o0, o1, o2, o3);
      }
    }
}

// the lookups of one slab: row v of the slab, CPL columns, every row of
// M per load, from O buffer Ob and the slab's staged indices st
template <int C, int MW, int BN>
__device__ __forceinline__ void lookups(const unsigned char* st, const float* Ob,
                                        float (&acc)[BN / (WARPS * MW) * MW],
                                        int vl, int grp, int j0, int v) {
  constexpr int VL = vl_of(MW), CPL = BN / (WARPS * MW), PITCH = BN + PAD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint32_t w[CPL / 4];
    if constexpr (kVariant == kNoIndex) {
#pragma unroll
      for (int k = 0; k < CPL / 4; ++k) w[k] = hashed_indices(j0 + grp * CPL + 4 * k, v, c);
    } else {
      const unsigned char* ir = st + (c * VL + vl) * PITCH + grp * CPL;
      if constexpr (CPL % 16 == 0) {
#pragma unroll
        for (int k = 0; k < CPL / 16; ++k) {
          const uint4 u = reinterpret_cast<const uint4*>(ir)[k];
          w[4 * k] = u.x; w[4 * k + 1] = u.y; w[4 * k + 2] = u.z; w[4 * k + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < CPL / 8; ++k) {
          const uint2 u = reinterpret_cast<const uint2*>(ir)[k];
          w[2 * k] = u.x; w[2 * k + 1] = u.y;
        }
      }
    }
    const float* Oc = Ob + c * KC * LINE + vl * MW;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const uint32_t e = (w[q >> 2] >> (8 * (q & 3))) & 0xffu;
      if constexpr (kVariant == kNoLookup) {
        acc[q * MW] += (float)e;
      } else if constexpr (MW == 4) {
        const float4 f = *reinterpret_cast<const float4*>(Oc + e * LINE);
        acc[q * 4] += f.x; acc[q * 4 + 1] += f.y;
        acc[q * 4 + 2] += f.z; acc[q * 4 + 3] += f.w;
      } else if constexpr (MW == 2) {
        const float2 f = *reinterpret_cast<const float2*>(Oc + e * LINE);
        acc[q * 2] += f.x; acc[q * 2 + 1] += f.y;
      } else {
        acc[q] += Oc[e * LINE];
      }
    }
  }
}

template <int C, int MW, int BN, bool RECOMPUTE>
__device__ __forceinline__ void lookup_body(const Args& a) {
  using L = Layout<C, MW, BN, RECOMPUTE>;
  constexpr int VL = L::VL, CPL = L::CPL;
  constexpr int Q = CPL * MW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cbT = reinterpret_cast<float*>(smem);         // (C, KC, D), recompute only
  float* Os = reinterpret_cast<float*>(smem + L::CB_BYTES);  // (C, KC, LINE)
  unsigned char* ring = smem + L::RING;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int vl = lane % VL;                            // the lane's slab row
  const int grp = (t >> 5) * MW + lane / VL;           // its column group
  Tile tl;
  tl.j0 = blockIdx.x * BN;
  tl.m0 = blockIdx.z * MT;
  tl.mt = min(MT, a.M - tl.m0);
  tl.slab0 = blockIdx.y * a.slabs_per_split;
  tl.nslab = max(0, min(a.slabs_per_split, (a.V + VL - 1) / VL - tl.slab0));
  tl.v_hi = min(a.V, (tl.slab0 + tl.nslab) * VL);      // rows [slab0*VL, v_hi)
  stamp(a.trace, 0);

  // every ring slot loads from the start (slab k's cp.async group is the
  // k-th committed); the codebooks and the first O rows meanwhile
  for (int s = 0; s < a.stages; ++s) issue_stage<C, MW, BN, RECOMPUTE>(a, tl, ring, s);
  if constexpr (RECOMPUTE) {
    for (int q = t; q < C * D * KC; q += THREADS) {   // (c, i, e) -> (c, e, i)
      const int e = q % KC, i = (q / KC) % D, c = q / (KC * D);
      cbT[(c * KC + e) * D + i] = a.cb[q];
    }
  }
  float4 oreg[C][4];
  if constexpr (!RECOMPUTE) {
    if (tl.nslab > 0) load_o<C, MW>(a, tl, 0, oreg);
  }
  auto stage_of = [&](int s) { return ring + (s % a.stages) * L::STAGE; };

  float acc[Q];                                        // (column, row of M)
#pragma unroll
  for (int i = 0; i < Q; ++i) acc[i] = 0.f;

  for (int s = 0; s < tl.nslab; ++s) {
    // committed: stages + max(0, s - 1) groups; slab s's is the s-th,
    // so at most stages - 1 (s = 0) or stages - 2 may stay pending
    if (a.stages == 1) {
      if (s > 0) {
        __syncthreads();                             // lookups of s-1 done
        issue_stage<C, MW, BN, RECOMPUTE>(a, tl, ring, s);
      }
      cp_async_wait<0>();
    } else {
      cp_async_wait_dyn(s == 0 ? a.stages - 1 : a.stages - 2);  // own copies landed
    }
    __syncthreads();                                 // everyone's; O free
    if (s == 0) stamp(a.trace, 1);
    if (a.stages > 1 && s > 0)                       // into the slot of slab s-1
      issue_stage<C, MW, BN, RECOMPUTE>(a, tl, ring, s + a.stages - 1);
    if (kVariant != kNoO) {
      if constexpr (RECOMPUTE) recompute_o<C, MW, BN>(stage_of(s), cbT, Os);
      else store_o<C, MW>(oreg, Os);
    }
    __syncthreads();                                 // O of slab s complete
    if constexpr (!RECOMPUTE) {
      if (s + 1 < tl.nslab) load_o<C, MW>(a, tl, s + 1, oreg);  // in flight during the lookups
    }
    const int v = (tl.slab0 + s) * VL + vl;
    if (v < tl.v_hi) lookups<C, MW, BN>(stage_of(s), Os, acc, vl, grp, tl.j0, v);
  }
  cp_async_wait<0>();
  __syncthreads();                                     // O slab free for the partials
  if (tl.nslab == 0) stamp(a.trace, 1);
  stamp(a.trace, 2);

  // lane vl ends with columns vl*KEEP ... vl*KEEP + KEEP - 1 of its
  // group, every row of M (acc index = column * MW + m)
  butterfly<VL, Q, 0>(acc, vl);
  float* Ps = Os;                                      // partials (MW, BN)
#pragma unroll
  for (int k = 0; k < L::KEEP; ++k)
#pragma unroll
    for (int m = 0; m < MW; ++m)
      Ps[m * BN + grp * CPL + vl * L::KEEP + k] = acc[k * MW + m];

  if constexpr (kVariant == kOneLaunch) {
    __syncthreads();
    for (int q = t; q < tl.mt * BN; q += THREADS) {
      const int m = q / BN, j = tl.j0 + q % BN;
      if (j < a.N) a.y[(size_t)(tl.m0 + m) * a.N + j] = Ps[m * BN + q % BN];
    }
    return;
  }
  // the cluster's CTAs are the V splits of this tile: rank r sums its
  // share of the columns over every rank, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  stamp(a.trace, 3);
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y / a.cs;
  const int cols = (BN + a.cs - 1) / a.cs;
  const int c0 = rank * cols, nc = max(0, min(BN, c0 + cols) - c0);
  for (int q = t; q < tl.mt * nc; q += THREADS) {
    const int m = q / nc, col = c0 + q % nc, j = tl.j0 + col;
    if (j >= a.N) continue;
    float part[CS_MAX];                                // all remote loads in flight
#pragma unroll
    for (int p = 0; p < CS_MAX; ++p)
      part[p] = p < a.cs ? cluster.map_shared_rank(Ps, p)[m * BN + col] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < CS_MAX; ++p)
      if (p < a.cs) sum += part[p];
    if (a.groups == 1)
      a.y[(size_t)(tl.m0 + m) * a.N + j] = sum * a.scale[j];
    else
      a.ws[((size_t)g * a.M + tl.m0 + m) * a.N + j] = sum;
  }
  cluster.sync();                                      // keep Ps alive for the readers
  stamp(a.trace, 4);
}

// Raise a kernel's dynamic shared-memory limit once per device, not on
// every launch: the attribute call is host work on the decode step's
// critical path.
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}

template <typename K>
cudaError_t launch_cluster(K kernel, const Args& a, int bn, size_t smem,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + bn - 1) / bn, a.cs * a.groups, (a.M + MT - 1) / MT);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// clusters of `cs` CTAs with `smem` bytes each that the card holds at
// once (cudaOccupancyMaxActiveClusters), for the tile model
template <typename K>
cudaError_t max_clusters(K kernel, int cs, size_t smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cs, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// y[m, j] = scale[j] * sum_{g < groups} ws[g, m, j], summed in order
// (the body of each kernel's second launch)
__device__ __forceinline__ void reduce_groups(const float* __restrict__ ws,
                                              const float* __restrict__ scale,
                                              float* __restrict__ y, int M,
                                              int N, int groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < groups; ++p) s += ws[(size_t)p * MN + i];
  y[i] = s * scale[i % N];
}

}  // namespace eva
