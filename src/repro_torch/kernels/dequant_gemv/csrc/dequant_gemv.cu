// Conventional VQ matmul (rebuild the weight from its codebooks, then
// multiply) for Hopper (sm_90a) on the tensor cores: the prefill path of
// every VQ linear.
//
// Replaces the Pallas TPU kernel `_dequant_gemv_kernel` /
// `dequant_gemv_pallas` (src/repro/kernels/dequant_gemv/kernel.py:20 and
// :47): w[v*8 + i, j] = sum_c cb[c, i, I[c, v, j]] rebuilt tile by tile
// from uint8 indices, y = (X . W) * scale with an fp32 accumulator.
// x (M, V*8) bf16 or fp32, codebooks (C, 8, 256) fp32 as stored in the VQ
// weight, I (C, V, N) uint8, scale (N,) fp32 -> y (M, N) fp32 or bf16.
//
// Precision. The reference multiplies in fp32, and the port holds the
// kernel to 1e-4 * max|y| of it; one bf16 product on rounded weights
// (8 significant bits) misses that. So each rebuilt fp32 weight is split
// into two bf16 parts, w_hi = bf16(w) and w_lo = bf16(w - w_hi), which
// carry ~16 significant bits, and the tensor cores take exact bf16
// products with fp32 accumulation: y = x.w_hi + x.w_lo for bf16 x (every
// serving call), and, with x = x_hi + x_lo split the same way for fp32 x,
// y = x_hi.w_hi + x_hi.w_lo + x_lo.w_hi (the dropped x_lo.w_lo is ~2^-18
// of a term).
//
// Bound on this card: operations. At a prefill bucket of M tokens the
// work is 2*M*K*N flops per product against C*V*N index bytes (~500
// flops per index byte at M=256), so the least time is the products'
// flops over the bf16 tensor-core rate (989 TFLOP/s): 2 products for bf16
// x, 3 for fp32 x.
//
// Design. The weights are rebuilt on the CUDA cores straight into wgmma's
// A-operand registers, so the product is computed transposed: y^T = W^T .
// x^T, with W^T (64 weight columns per warpgroup) as A from registers and
// the x tile (up to 256 tokens, wgmma's N) as B from shared memory. One
// rebuilt fragment thus serves up to 256 tokens and never goes through
// shared memory. A CTA owns 128 weight columns (two consumer
// warpgroups) x T tokens (T = 32, 64, 128 or 256, from M) x a range of
// K. A producer warp keeps a ring of stages full, each 64 K-elements
// (8 index rows) deep: the x tiles (bf16, x_hi and x_lo for fp32 x) come
// in by TMA with the 128-byte swizzle the wgmma descriptor reads, the
// index rows of the CTA's columns by 16-byte cp.async, and both complete
// on the stage's mbarrier. The codebooks sit in shared memory,
// centroid-major, for the CTA's lifetime. Per k16 step each consumer
// thread rebuilds its 8 weights (2 index rows x 2 columns x 2 elements:
// C float2 gathers each, C a template argument), splits them and issues
// the step's 2 or 3 wgmmas; while a warpgroup waits for them, the other
// warpgroup rebuilds or multiplies. The rebuild on the CUDA cores takes
// about as long as the products and the two overlap little. A
// warp-specialised layout (rebuild warpgroups writing W_hi^T and W_lo^T
// into swizzled shared memory for the next stage while MMA warpgroups
// keep a wgmma group in flight, both operands from shared memory) ran
// slower at the 32- to 128-token buckets and with fp32 x, and only a few
// per cent faster at 256 tokens and above: it has half the rebuilding
// threads an SM and adds the W tiles' shared-memory stores and reads.
// Ragged M, N, K are masked: TMA zero-fills x past M and K, index bytes
// past N and V are zero-filled and their columns not written. When the
// tiles cannot fill the card (a small bucket, or N = 4096), the K range is
// split across CTAs, which write partial sums to a (splits, M, N)
// workspace that a second small kernel adds in split order before
// scaling; each output is otherwise summed by one warpgroup in K order,
// so two runs are bitwise equal.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int KC = 256;          // 2^n centroids per codebook
constexpr int D = 8;             // VQ vector length
constexpr int VS = 8;            // index rows per stage
constexpr int KS = VS * D;       // K elements per stage: one 128-byte swizzle row
constexpr int NWG = 2;           // consumer warpgroups
constexpr int BN = 64 * NWG;     // weight columns per CTA
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int C_MAX = 4;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

template <int NX> struct Stages { static constexpr int value = NX == 1 ? 4 : 2; };

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a barrier that never completes traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// the executing thread's earlier cp.asyncs arrive on `bar` when they land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// pin register values at this point of the program: the fragments are
// computed before wgmma.fence and the accumulators are never copied
// between wgmmas
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor of a K-major bf16 tile written by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes
// apart (SBO), swizzle mode 1 in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, fp32) += A (64 x 16, bf16 from registers) . B (16 x N, bf16
// in shared memory, K-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b);

template <> __device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// w = sum_c cb[c][I[c][v][col]][2t..2t+1] (in c order, as the reference).
// C is a template argument: with a runtime count every codebook's gather
// ends a basic block, and the gathers of a step could not overlap.
template <int C>
__device__ __forceinline__ float2 rebuild(const float* cbs, const uint8_t* ib, int row, int col,
                                          int t) {
  float2 w = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = ib[(c * VS + row) * BN + col];
    const float2 v = *reinterpret_cast<const float2*>(cbs + (c * KC + e) * D + 2 * t);
    w.x += v.x;
    w.y += v.y;
  }
  return w;
}

// hi and lo bf16 pairs of two rebuilt weights
__device__ __forceinline__ void split2(float2 w, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w.x, w.y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(w.x - hf.x, w.y - hf.y));
}

// T: tokens per CTA (wgmma N), two CTAs an SM for T <= 64; NX: 1 (bf16 x)
// or 2 (x_hi, x_lo); C: codebooks
// out_mode: 0 y fp32, 1 y bf16, 2 unscaled fp32 partial sums at
// part[(blockIdx.z * M + m) * N + n]
template <int T, int NX, int C>
__global__ void __launch_bounds__(THREADS, T <= 64 ? 2 : 1)
dequant_gemv_kernel(const __grid_constant__ CUtensorMap x_hi,
                    const __grid_constant__ CUtensorMap x_lo,
                    const float* __restrict__ cb,      // (C, D, KC)
                    const uint8_t* __restrict__ idx,   // (C, V, N)
                    const float* __restrict__ scale,   // (N,)
                    void* __restrict__ out, int M, int V, int N,
                    int stages_per_split, int idx_vec16, int out_mode) {
  constexpr int S = Stages<NX>::value;
  constexpr int XBYTES = T * KS * 2;  // one x tile of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                                   // (S, NX, T, 128 B)
  uint8_t* is = xs + S * NX * XBYTES;                   // (S, C, VS, BN)
  float* cbs = reinterpret_cast<float*>(is + S * C * VS * BN);  // (C, KC, D)
  uint64_t* full = reinterpret_cast<uint64_t*>(cbs + C * KC * D);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * T;
  const int n_stages = (V + VS - 1) / VS;
  const int j0 = blockIdx.z * stages_per_split;
  const int nst = min(stages_per_split, n_stages - j0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);        // 32 producer lanes + the TMA's expect_tx
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int d = threadIdx.x; d < C * KC * D; d += THREADS) {
    const int i = d % D, ck = d / D;  // ck = c * KC + k
    cbs[d] = cb[((ck / KC) * D + i) * KC + ck % KC];
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    const int lane = threadIdx.x & 31;
    for (int j = 0; j < nst; ++j) {
      const int st = j % S;
      if (j >= S) mbar_wait(&empty[st], ((j / S) - 1) & 1);
      const int v0 = (j0 + j) * VS;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], NX * XBYTES);
        tma_load_2d(xs + st * NX * XBYTES, &x_hi, &full[st], v0 * D, m0);
        if (NX == 2) tma_load_2d(xs + (st * NX + 1) * XBYTES, &x_lo, &full[st], v0 * D, m0);
      }
      uint8_t* dst = is + st * C * VS * BN;
      if (idx_vec16) {
        for (int q = lane; q < C * VS * (BN / 16); q += 32) {
          const int row = q / (BN / 16);
          const int n = n0 + (q - row * (BN / 16)) * 16;
          const int c = row / VS, v = v0 + row % VS;
          const bool ok = v < V && n < N;  // N % 16 == 0: whole chunks
          cp_async16(dst + q * 16, ok ? idx + ((size_t)c * V + v) * N + n : idx, ok ? 16 : 0);
        }
        cp_async_arrive(&full[st]);
      } else {
        for (int q = lane; q < C * VS * BN; q += 32) {
          const int row = q / BN;
          const int n = n0 + q - row * BN;
          const int c = row / VS, v = v0 + row % VS;
          dst[q] = (v < V && n < N) ? idx[((size_t)c * V + v) * N + n] : 0;
        }
        mbar_arrive(&full[st]);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;  // and col + 8

  float acc[T / 2];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
  pin<T / 2>(acc);
  uint32_t fh[4], fl[4];

  // Each step's wgmmas are waited for before the next fragment is
  // written: ptxas serializes wgmmas whose register operands are written
  // while earlier ones run. The other warpgroup's rebuild or wgmmas fill
  // the wait (making the two take turns by named barriers measured no
  // faster).
  for (int j = 0; j < nst; ++j) {
    const int st = j % S;
    mbar_wait(&full[st], (j / S) & 1);
    const uint8_t* ib = is + st * C * VS * BN;
    const uint32_t xa = smem_u32(xs + st * NX * XBYTES);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      // A fragment: rows col, col + 8; k 2t..2t+1 of index row 2kk, then
      // of index row 2kk + 1
      split2(rebuild<C>(cbs, ib, 2 * kk, col, t), fh[0], fl[0]);
      split2(rebuild<C>(cbs, ib, 2 * kk, col + 8, t), fh[1], fl[1]);
      split2(rebuild<C>(cbs, ib, 2 * kk + 1, col, t), fh[2], fl[2]);
      split2(rebuild<C>(cbs, ib, 2 * kk + 1, col + 8, t), fh[3], fl[3]);
      pin<4>(fh);
      pin<4>(fl);
      pin<T / 2>(acc);
      wgmma_fence();
      wgmma_rs<T>(acc, fh, desc_sw128(xa + kk * 32));
      wgmma_rs<T>(acc, fl, desc_sw128(xa + kk * 32));
      if (NX == 2) wgmma_rs<T>(acc, fh, desc_sw128(xa + XBYTES + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
      pin<T / 2>(acc);
    }
    mbar_arrive(&empty[st]);
  }

  // acc[4q + 2h + e]: weight column col + 8h, token 8q + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + col + 8 * h;
    if (n >= N) continue;
    const float sc = out_mode == 2 ? 1.f : scale[n];
#pragma unroll
    for (int q = 0; q < T / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * q + 2 * t + e;
        if (m >= M) continue;
        const float v = acc[4 * q + 2 * h + e];
        if (out_mode == 0)
          static_cast<float*>(out)[(size_t)m * N + n] = v * sc;
        else if (out_mode == 1)
          static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] = __float2bfloat16(v * sc);
        else
          static_cast<float*>(out)[((size_t)blockIdx.z * M + m) * N + n] = v;
      }
    }
  }
}

// y[m, n] = scale[n] * sum_s part[s, m, n], in split order
__global__ void dequant_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ scale, void* __restrict__ y,
                                    int M, int N, int splits, int out_bf16) {
  const size_t MN = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * MN + i];
    s *= scale[i % N];
    if (out_bf16)
      static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(s);
    else
      static_cast<float*>(y)[i] = s;
  }
}

// x (fp32) -> x_hi = bf16(x), x_lo = bf16(x - x_hi)
__global__ void dequant_split_x_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                               __nv_bfloat16* __restrict__ lo, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float v = x[i];
    const __nv_bfloat16 h = __float2bfloat16(v);
    hi[i] = h;
    lo[i] = __float2bfloat16(v - __bfloat162float(h));
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// (rows, K) bf16 row-major, boxes of (T rows, 64 K) with the 128-byte swizzle
bool x_map(CUtensorMap* map, const void* x, int rows, int K, int T) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KS, (cuuint32_t)T};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int T, int NX, int C>
cudaError_t launch_c(const CUtensorMap& hi, const CUtensorMap& lo, const float* cb,
                     const uint8_t* idx, const float* scale, void* out, int M, int V, int N,
                     int splits, int idx_vec16, int out_mode, cudaStream_t st) {
  constexpr int S = Stages<NX>::value;
  const size_t smem = 1024 + (size_t)S * NX * T * KS * 2 + (size_t)S * C * VS * BN +
                      (size_t)C * KC * D * 4 + 2 * S * sizeof(uint64_t);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = dequant_gemv_kernel<T, NX, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's L1/shared memory as shared
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const int n_stages = (V + VS - 1) / VS;
  const int per = (n_stages + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + T - 1) / T, (n_stages + per - 1) / per);
  kern<<<grid, THREADS, smem, st>>>(hi, lo, cb, idx, scale, out, M, V, N, per, idx_vec16,
                                    out_mode);
  return cudaGetLastError();
}

template <int T, int NX>
cudaError_t launch_t(const CUtensorMap& hi, const CUtensorMap& lo, const float* cb,
                     const uint8_t* idx, const float* scale, void* out, int M, int V, int N,
                     int C, int splits, int idx_vec16, int out_mode, cudaStream_t st) {
  switch (C) {
    case 1: return launch_c<T, NX, 1>(hi, lo, cb, idx, scale, out, M, V, N, splits, idx_vec16, out_mode, st);
    case 2: return launch_c<T, NX, 2>(hi, lo, cb, idx, scale, out, M, V, N, splits, idx_vec16, out_mode, st);
    case 3: return launch_c<T, NX, 3>(hi, lo, cb, idx, scale, out, M, V, N, splits, idx_vec16, out_mode, st);
    case 4: return launch_c<T, NX, 4>(hi, lo, cb, idx, scale, out, M, V, N, splits, idx_vec16, out_mode, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NX>
cudaError_t launch_nx(const CUtensorMap& hi, const CUtensorMap& lo, const float* cb,
                      const uint8_t* idx, const float* scale, void* out, int M, int V, int N,
                      int C, int T, int splits, int idx_vec16, int out_mode,
                      cudaStream_t st) {
  switch (T) {
    case 32: return launch_t<32, NX>(hi, lo, cb, idx, scale, out, M, V, N, C, splits, idx_vec16, out_mode, st);
    case 64: return launch_t<64, NX>(hi, lo, cb, idx, scale, out, M, V, N, C, splits, idx_vec16, out_mode, st);
    case 128: return launch_t<128, NX>(hi, lo, cb, idx, scale, out, M, V, N, C, splits, idx_vec16, out_mode, st);
    case 256: return launch_t<256, NX>(hi, lo, cb, idx, scale, out, M, V, N, C, splits, idx_vec16, out_mode, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, V*8): bf16 (x_f32 = 0) or fp32 (x_f32 = 1; split into the bf16
// workspaces x_hi, x_lo, each M*V*8); cb (C, 8, 256) fp32; idx (C, V, N)
// uint8; scale (N,) fp32; y (M, N) fp32 or bf16 (out_bf16); T the tokens
// per CTA (32, 64, 128 or 256); splits > 1 needs part (splits, M, N) fp32.
// splits must leave every split at least one stage of 8 index rows.
extern "C" int dequant_gemv_launch(const void* x, void* x_hi, void* x_lo, const void* cb,
                                   const void* idx, const void* scale, void* y, void* part,
                                   int M, int V, int N, int C, int T, int splits, int x_f32,
                                   int out_bf16, void* stream) {
  const int n_stages = (V + VS - 1) / VS;
  if (M < 1 || V < 1 || N < 1 || C < 1 || C > C_MAX || splits < 1 || splits > n_stages ||
      (splits > 1 && part == nullptr) || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = V * D;
  const void* xh = x;
  if (x_f32) {
    if (x_hi == nullptr || x_lo == nullptr) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)M * K;
    dequant_split_x_kernel<<<(unsigned)std::min<size_t>((n + 255) / 256, 4096), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(x_hi),
        static_cast<__nv_bfloat16*>(x_lo), n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xh = x_hi;
  }
  CUtensorMap hi, lo;
  if (!x_map(&hi, xh, M, K, T) || !x_map(&lo, x_f32 ? x_lo : xh, M, K, T))
    return (int)cudaErrorInvalidValue;
  const int idx_vec16 = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(idx) & 15) == 0);
  const int per = (n_stages + splits - 1) / splits;
  splits = (n_stages + per - 1) / per;
  const int out_mode = splits > 1 ? 2 : (out_bf16 ? 1 : 0);
  void* out = splits > 1 ? part : y;
  const float* cbp = static_cast<const float*>(cb);
  const uint8_t* ip = static_cast<const uint8_t*>(idx);
  const float* sp = static_cast<const float*>(scale);
  cudaError_t err =
      x_f32 ? launch_nx<2>(hi, lo, cbp, ip, sp, out, M, V, N, C, T, splits, idx_vec16, out_mode, st)
            : launch_nx<1>(hi, lo, cbp, ip, sp, out, M, V, N, C, T, splits, idx_vec16, out_mode, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t MN = (size_t)M * N;
  dequant_reduce_kernel<<<(unsigned)std::min<size_t>((MN + 255) / 256, 8192), 256, 0, st>>>(
      static_cast<const float*>(part), sp, y, M, N, splits, out_bf16);
  return (int)cudaGetLastError();
}
