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
// Bound on this card: bytes. The index matrix (C*V*N bytes) and one read
// of O (C*M*V*1 KB) are the traffic: for llama2-7b's grouped `gu` at M=4
// (V=512, N=22016, C=2), 22.5 MB of indices + 4.2 MB of O, 8.1 us at
// 3.35 TB/s; the fp32 gather's shared-memory floor sits above it at
// M >= 4 (eva_lookup.cuh).
//
// Design: eva_lookup.cuh (the same kernel body as fused_vq_matmul.cu),
// with the slab's O read from device memory instead of recomputed: each
// thread loads its 16-byte pieces of the next slab's O rows (C x 4
// float4, all in flight during this slab's lookups) and stores them
// entry-major, a quarter-warp's lanes on distinct slab rows so the
// stores are conflict-free. The TPU kernel keeps the (M, bn) output
// block in VMEM across a sequential V grid axis; here the V splits of a
// column tile are the CTAs of a cluster, summed through distributed
// shared memory in rank order.
#include "../../eva_lookup/csrc/eva_lookup.cuh"

namespace {

using eva::Args;

template <int C, int MW, int BN>
__global__ void __launch_bounds__(eva::THREADS, 1)
oc_lookup_kernel(const Args a) {
  eva::lookup_body<C, MW, BN, false>(a);
}

__global__ void oc_split_reduce_kernel(const float* __restrict__ ws,
                                       const float* __restrict__ scale,
                                       float* __restrict__ y, int M, int N,
                                       int groups) {
  eva::reduce_groups(ws, scale, y, M, N, groups);
}

template <int C, int MW, int BN>
cudaError_t launch(const Args& a, int* max_clusters, cudaStream_t st) {
  static std::atomic<bool> done[eva::MAX_DEVICES];
  auto kernel = oc_lookup_kernel<C, MW, BN>;
  const size_t smem = eva::Layout<C, MW, BN, false>::smem(a.stages);
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

Args make_args(const void* O, const void* idx, const void* scale, void* y,
               void* ws, int M, int V, int N, int stages, int cs, int groups,
               int slabs_per_split) {
  Args a;
  a.x = nullptr;
  a.cb = nullptr;
  a.O = static_cast<const float*>(O);
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
  oc_split_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      a.ws, a.scale, a.y, a.M, a.N, a.groups);
  return (int)cudaGetLastError();
}

}  // namespace

// O (C, M, V, 256) fp32, 16-byte aligned; idx (C, V, N) uint8; scale
// (N,) fp32; y (M, N) fp32; ws (groups, M, N) fp32 when groups > 1. The
// launch shape (bn, stages, cs, groups, slabs_per_split) is
// eva_lookup/tiles.lookup_tiles'.
extern "C" int oc_lookup_launch(const void* O, const void* idx,
                                const void* scale, void* y, void* ws, int M,
                                int V, int N, int C, int bn, int stages,
                                int cs, int groups, int slabs_per_split,
                                void* stream) {
  return run(make_args(O, idx, scale, y, ws, M, V, N, stages, cs, groups,
                       slabs_per_split),
             C, bn, static_cast<cudaStream_t>(stream));
}

#if EVA_VARIANT == 5  // eva::kTrace
// oc_lookup_launch, with trace (grid CTAs x 5) u64 receiving each CTA's
// %globaltimer stamps
extern "C" int oc_lookup_launch_traced(const void* O, const void* idx,
                                       const void* scale, void* y, void* ws,
                                       void* trace, int M, int V, int N,
                                       int C, int bn, int stages, int cs,
                                       int groups, int slabs_per_split,
                                       void* stream) {
  Args a = make_args(O, idx, scale, y, ws, M, V, N, stages, cs, groups,
                     slabs_per_split);
  a.trace = static_cast<unsigned long long*>(trace);
  return run(a, C, bn, static_cast<cudaStream_t>(stream));
}
#endif

// clusters of cs CTAs of this launch shape the current device holds at
// once, into *out (for the tile model)
extern "C" int oc_lookup_max_clusters(void* out, int M, int C, int bn,
                                      int stages, int cs, void* stream) {
  (void)stream;
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, M, 1,
                           16, stages, cs, 1, 1);
  return (int)dispatch(C, bn, a, static_cast<int*>(out), nullptr);
}
