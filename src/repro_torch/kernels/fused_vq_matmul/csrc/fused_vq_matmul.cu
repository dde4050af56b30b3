// Fused EVA matmul for Hopper (sm_90a): y = x @ W_hat with W_hat held as
// C additive uint8-indexed codebooks, computed without ever rebuilding W.
//
// Replaces the Pallas TPU kernel `_fused_kernel` / `fused_vq_matmul_pallas`
// (src/repro/kernels/fused_vq_matmul/kernel.py:49 and :89):
//
//   O[c, m, v, :] = x[m, v, :] . B[c]                 (VQ-GEMM, d=8 deep)
//   y[m, j]       = scale[j] * sum_c sum_v O[c, m, v, I[c, v, j]]
//
// Bound on this card: bytes — the index matrix (12.6 MB for llama2-7b's
// grouped wqkv at 2 bits a weight) over 3.35 TB/s; the fp32 gather's
// shared-memory floor sits above it at M >= 4 (eva_lookup.cuh).
//
// Design: eva_lookup.cuh, with the output codebook recomputed per slab.
// The Pallas kernel keeps one row block's whole O (C, M, V, 256) in VMEM
// across every N tile; that is 1 MiB a token row at K=4096, far beyond
// the 227 KB a CTA may use, so each CTA recomputes the O of the slab it
// is on (C*256 entries x 32 (v, m) slots, 8 FMAs each) from x rows staged
// with its index rows and the codebooks it transposed into shared memory
// at start. That costs 2*256*8 / BN flops a lookup: BN stays at 1024
// columns unless a 512-column tile fills the card better
// (eva_lookup/tiles.py).
#include "../../eva_lookup/csrc/eva_lookup.cuh"

namespace {

using eva::Args;

template <int C, int MW, int BN>
__global__ void __launch_bounds__(eva::THREADS, 1)
fused_vq_kernel(const Args a) {
  eva::lookup_body<C, MW, BN, true>(a);
}

__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ scale,
                                    float* __restrict__ y, int M, int N,
                                    int groups) {
  eva::reduce_groups(ws, scale, y, M, N, groups);
}

template <int C, int MW, int BN>
cudaError_t launch(const Args& a, int* max_clusters, cudaStream_t st) {
  static std::atomic<bool> done[eva::MAX_DEVICES];
  auto kernel = fused_vq_kernel<C, MW, BN>;
  const size_t smem = eva::Layout<C, MW, BN, true>::smem(a.stages);
  if (smem > (size_t)eva::SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = eva::allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  if (max_clusters) return eva::max_clusters(kernel, a.cs, smem, max_clusters);
  return eva::launch_cluster(kernel, a, BN, smem, st);
}

template <int C, int MW>
cudaError_t by_bn(int bn, const Args& a, int* mc, cudaStream_t st) {
  switch (bn) {
    case 1024: return launch<C, MW, 1024>(a, mc, st);
    case 512: return launch<C, MW, 512>(a, mc, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t by_mw(int M, int bn, const Args& a, int* mc, cudaStream_t st) {
  switch (M == 1 ? 1 : M == 2 ? 2 : 4) {
    case 1: return by_bn<C, 1>(bn, a, mc, st);
    case 2: return by_bn<C, 2>(bn, a, mc, st);
    default: return by_bn<C, 4>(bn, a, mc, st);
  }
}

cudaError_t dispatch(int C, int bn, const Args& a, int* mc, cudaStream_t st) {
  if (a.M < 1 || a.V < 1 || a.N < 1 || a.stages < 1 || a.stages > 4 ||
      a.cs < 1 || a.cs > eva::CS_MAX || a.groups < 1 || a.slabs_per_split < 1)
    return cudaErrorInvalidValue;
  switch (C) {  // timing variants are built for the served C = 2 only
    case 2: return by_mw<2>(a.M, bn, a, mc, st);
#if EVA_VARIANT == 0
    case 1: return by_mw<1>(a.M, bn, a, mc, st);
    case 3: return by_mw<3>(a.M, bn, a, mc, st);
    case 4: return by_mw<4>(a.M, bn, a, mc, st);
#endif
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* x, const void* cb, const void* idx,
               const void* scale, void* y, void* ws, int M, int V, int N,
               int stages, int cs, int groups, int slabs_per_split) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.cb = static_cast<const float*>(cb);
  a.O = nullptr;
  a.idx = static_cast<const uint8_t*>(idx);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.ws = static_cast<float*>(ws);
  a.trace = nullptr;
  a.M = M; a.V = V; a.N = N;
  a.stages = stages; a.cs = cs; a.groups = groups;
  a.slabs_per_split = slabs_per_split;
  a.idx_aligned = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(idx) % 16 == 0);
  return a;
}

// the lookup, then (groups > 1) the split reduce
int run(const Args& a, int C, int bn, cudaStream_t st) {
  cudaError_t err = dispatch(C, bn, a, nullptr, st);
  if (err != cudaSuccess || a.groups == 1 || eva::kVariant == eva::kOneLaunch)
    return (int)err;
  const size_t MN = (size_t)a.M * a.N;
  split_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      a.ws, a.scale, a.y, a.M, a.N, a.groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, V, 8) fp32 and 16-byte aligned; cb (C, 8, 256) fp32; idx (C, V,
// N) uint8; scale (N,) fp32; y (M, N) fp32; ws (groups, M, N) fp32 when
// groups > 1. The launch shape (bn, stages, cs, groups, slabs_per_split)
// is eva_lookup/tiles.lookup_tiles'.
extern "C" int fused_vq_matmul_launch(const void* x, const void* cb,
                                      const void* idx, const void* scale,
                                      void* y, void* ws, int M, int V, int N,
                                      int C, int bn, int stages, int cs,
                                      int groups, int slabs_per_split,
                                      void* stream) {
  return run(make_args(x, cb, idx, scale, y, ws, M, V, N, stages, cs, groups,
                       slabs_per_split),
             C, bn, static_cast<cudaStream_t>(stream));
}

#if EVA_VARIANT == 5  // eva::kTrace
// fused_vq_matmul_launch, with trace (grid CTAs x 5) u64 receiving each
// CTA's %globaltimer stamps
extern "C" int fused_vq_matmul_launch_traced(
    const void* x, const void* cb, const void* idx, const void* scale, void* y,
    void* ws, void* trace, int M, int V, int N, int C, int bn, int stages,
    int cs, int groups, int slabs_per_split, void* stream) {
  Args a = make_args(x, cb, idx, scale, y, ws, M, V, N, stages, cs, groups,
                     slabs_per_split);
  a.trace = static_cast<unsigned long long*>(trace);
  return run(a, C, bn, static_cast<cudaStream_t>(stream));
}
#endif

// clusters of cs CTAs of this launch shape the current device holds at
// once, into *out (for the tile model)
extern "C" int fused_vq_matmul_max_clusters(void* out, int M, int C, int bn,
                                            int stages, int cs, void* stream) {
  (void)stream;
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, M, 1, 16, stages, cs, 1, 1);
  return (int)dispatch(C, bn, a, static_cast<int*>(out), nullptr);
}
