// INT8 x INT8 -> INT32 GEMM with per-row / per-column dequant scales, for
// Hopper (sm_90a): the INT8 prefill mode of the EVA PE array.
//
// Replaces the Pallas TPU kernel `_int8_gemm_kernel` / `int8_gemm_pallas`
// (src/repro/kernels/int8_gemm/kernel.py:22 and :43): xq (M, K) int8 and
// wq (K, N) int8, both row-major, xs (M, 1) and ws (1, N) fp32 ->
// y (M, N) fp32 = float(sum_k xq * wq) * xs * ws. The int32 sum is exact;
// the scales are applied as (acc * xs) * ws with round-to-nearest
// multiplies, in the Pallas kernel's order (kernel.py:36-40), so y is
// bit-equal to the plain version.
//
// Bound on this card: bytes at the serving shapes. The 4096 x 32000
// lm_head at a prefill of M <= 256 tokens moves 131 MB of int8 weight,
// M*K bytes of x and 4*M*N of fp32 output (0.049 ms at M=256, 3.35 TB/s)
// against 2*M*N*K int8 operations (0.034 ms at 1979 TOP/s).
//
// Design. The product is computed transposed, y^T = wq^T . xq^T, so the
// token tile T (32, 64, 128 or 256 from M: the wrapper's launch_shape) is
// wgmma's N dimension and every weight byte is read from device memory
// once for all of a tile's tokens: the grid runs over 128-column weight
// tiles (and over token tiles only above 256 tokens).
//  * A ring of stages, each 128 k deep (one 128-byte swizzle row), is
//    kept full by TMA: the x tile (T tokens x 128 k, K-major as stored,
//    the layout 8-bit wgmma takes) and the wq tile (128 k x 128 columns,
//    N-major as stored), both with the 128-byte swizzle, completing on
//    the stage's mbarrier. TMA zero-fills tokens past M, k past K and
//    columns past N. There is no producer warp: ptxas budgets the
//    registers of a warpgroup kernel by whole warpgroups, and one more
//    warp would cap the 256-token tile's 128 accumulators at 168
//    registers a thread and spill them. Thread 0 issues the loads: all S
//    stages first, then stage j + S - 2 right after the CTA-wide barrier
//    of stage j, which every thread reaches only once stage j - 2's
//    wgmmas have completed, so that slot is free.
//  * 8-bit wgmma takes only K-major operands, so each of the two consumer
//    warpgroups transposes its 64 columns of the stage's wq tile once, in
//    shared memory, into the K-major swizzled layout: a thread reads 4 k
//    rows of one 4-column word group, transposes the 4x4 bytes with
//    __byte_perm and writes 4 column words. Lanes cover 8 column groups x
//    4 k groups and rotate their read and write order by lane, so neither
//    side has a bank conflict.
//  * Both wgmma operands come from shared memory (m64nTk32, s8 x s8 ->
//    s32, four per stage), so the wgmmas stay asynchronous: a warpgroup
//    issues stage j's, then transposes stage j + 1 into the other half of
//    its double-buffered tile while they run; it waits for stage j's only
//    after issuing stage j + 1's.
//  * Epilogue: the int32 sums are staged as floats through the drained
//    ring (rows padded to 132 words: conflict-free), then every warp
//    writes whole 512-byte rows of y with 16-byte stores, applying the
//    scales as (acc * xs) * ws. Columns past N are not stored.
// Each output is one warpgroup's sum in k order, so two runs are bitwise
// equal.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 128;                  // k per stage: one 128-byte swizzle row
constexpr int NWG = 2;                   // consumer warpgroups
constexpr int BN = 64 * NWG;             // weight columns per CTA
constexpr int THREADS = 128 * NWG;
constexpr int WBYTES = KS * BN;          // a staged wq tile, [k][n]
constexpr int ABYTES = 64 * KS;          // a warpgroup's transposed tile, [n][k]
constexpr int OUT_STRIDE = BN + 4;       // floats per staged output row
constexpr int SMEM_MAX = 232448;         // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;

template <int T> struct Ring {
  static constexpr int XBYTES = T * KS;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int FIXED = 1024 + 2 * NWG * ABYTES + MAX_STAGES * 8;
  static constexpr int S = (SMEM_MAX - FIXED) / STAGE < MAX_STAGES
                               ? (SMEM_MAX - FIXED) / STAGE : MAX_STAGES;
  static constexpr int SMEM = 1024 + S * STAGE + 2 * NWG * ABYTES + S * 8;
  static_assert(S >= 3 && SMEM <= SMEM_MAX, "ring");
  static_assert(T * OUT_STRIDE * 4 <= S * STAGE, "epilogue staging");
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a barrier that never completes traps (a launch error) instead of hanging;
// ptxas puts a wgmma wait before the trap (C7517), on that cold path only
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// this thread's shared-memory stores, visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// keep the accumulators in place across the asynchronous wgmmas
template <int N>
__device__ __forceinline__ void pin(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), swizzle
// mode 1 in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, s32) += A (64 x 32, s8) . B (32 x N, s8), both K-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(int* d, uint64_t da, uint64_t db);

template <> __device__ __forceinline__ void wgmma_ss<32>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss<64>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss<128>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss<256>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "}, %128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Transpose this warpgroup's 64 columns of a staged wq tile (TMA, 128-byte
// swizzle: byte (k, n) at k*128 + ((n/16 ^ k%8) * 16) + n%16) into the
// K-major swizzled A tile (byte (r, k) at r*128 + ((k/16 ^ r%8) * 16) +
// k%16, r the column within the warpgroup). Unit of work: 4 k rows (k =
// 4kq..4kq+3) of one 4-column word group (n = 4nq..4nq+3). A warp takes 8
// groups nq x 4 groups kq per step, four steps; lane (nl = lane % 8, kx =
// lane / 8) reads its rows in the order i = s ^ (kx & 2) and writes its
// columns in the order j = (s + nl / 2) % 4, which keeps both the 32 reads
// and the 32 writes of each instruction on 32 distinct banks.
__device__ __forceinline__ void transpose_w(const uint8_t* __restrict__ wst,
                                            uint8_t* __restrict__ a, int wg, int warp,
                                            int lane) {
  const int nl_rel = lane & 7, kx = lane >> 3;
  const int ri = kx & 2, cj = (nl_rel >> 1) & 3;
  const uint32_t fix = ri ? 0x1054u : 0x5410u;  // undo the read rotation
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int blk = warp * 4 + it;  // 16 blocks: 2 column halves x 8 k groups
    const int nl = (blk & 1) * 8 + nl_rel;  // word group within the warpgroup
    const int nq = wg * 16 + nl;            // word group within the CTA tile
    const int kq = (blk >> 1) * 4 + kx;
    uint32_t rd[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 4 * kq + (s ^ ri);
      rd[s] = *reinterpret_cast<const uint32_t*>(wst + k * 128 + (((nq >> 2) ^ (k & 7)) << 4) +
                                                 ((nq & 3) << 2));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = (s + cj) & 3;
      const uint32_t sel = (uint32_t)(j | ((j + 4) << 4));
      const uint32_t lo = __byte_perm(rd[0], rd[1], sel);
      const uint32_t hi = __byte_perm(rd[2], rd[3], sel);
      const int r = 4 * nl + j;
      *reinterpret_cast<uint32_t*>(a + r * 128 + (((kq >> 2) ^ (r & 7)) << 4) + ((kq & 3) << 2)) =
          __byte_perm(lo, hi, fix);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap xmap,  // (M, K) int8
                 const __grid_constant__ CUtensorMap wmap,  // (K, N) int8
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 float* __restrict__ y, int M, int N, int K) {
  using R = Ring<T>;
  constexpr int S = R::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(  // S x (x tile, wq tile)
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* at = ring + S * R::STAGE;     // (2 buffers, NWG) transposed tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(at + 2 * NWG * ABYTES);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T;
  const int nst = (K + KS - 1) / KS;
  auto load = [&](int j) {  // stage j into its ring slot
    const int st = j % S;
    uint8_t* dst = ring + st * R::STAGE;
    mbar_arrive_expect_tx(&full[st], R::STAGE);
    tma_load_2d(dst, &xmap, &full[st], j * KS, m0);
    tma_load_2d(dst + R::XBYTES, &wmap, &full[st], n0, j * KS);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);  // the expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < S && j < nst; ++j) load(j);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;

  int acc[T / 2];
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = 0;
  pin<T / 2>(acc);

  for (int j = 0; j < nst; ++j) {
    const int st = j % S;
    mbar_wait(&full[st], (j / S) & 1);
    const uint8_t* stage = ring + st * R::STAGE;
    uint8_t* a = at + ((j & 1) * NWG + wg) * ABYTES;
    // the wgmmas of stage j - 2, which read this buffer, completed at the
    // wait of stage j - 1
    transpose_w(stage + R::XBYTES, a, wg, warp, lane);
    fence_proxy_async();
    __syncthreads();  // every thread is past the wait of stage j - 1
    if (threadIdx.x == 0 && j >= 2 && j - 2 + S < nst) load(j - 2 + S);
    const uint32_t aa = smem_u32(a), xa = smem_u32(stage);
    pin<T / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk)
      wgmma_ss<T>(acc, desc_sw128(aa + kk * 32), desc_sw128(xa + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // stage j - 1's wgmmas
    pin<T / 2>(acc);
  }
  wgmma_wait<0>();
  pin<T / 2>(acc);

  // acc[4q + 2h + e]: weight column 16 * warp + g + 8h of the warpgroup,
  // token 8q + 2t + e. Stage the sums as floats, [token][column], through
  // the drained ring.
  __syncthreads();  // every warpgroup's wgmmas are done
  float* out = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < T / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(8 * q + 2 * t + e) * OUT_STRIDE + wg * 64 + 16 * warp + g + 8 * h] =
            __int2float_rn(acc[4 * q + 2 * h + e]);
  __syncthreads();

  // warp cw writes tokens cw, cw + 8, ...: lane takes columns 4 lane..+3
  const int cw = threadIdx.x >> 5;
  const int n = n0 + 4 * lane;
  if (n >= N) return;  // N % 16 == 0: n < N means all four are in
  const float4 wv = *reinterpret_cast<const float4*>(ws + n);
  for (int ml = cw; ml < T && m0 + ml < M; ml += THREADS / 32) {
    const float4 v = *reinterpret_cast<const float4*>(out + ml * OUT_STRIDE + 4 * lane);
    const float sx = xs[m0 + ml];
    float4 r;
    r.x = __fmul_rn(__fmul_rn(v.x, sx), wv.x);
    r.y = __fmul_rn(__fmul_rn(v.y, sx), wv.y);
    r.z = __fmul_rn(__fmul_rn(v.z, sx), wv.z);
    r.w = __fmul_rn(__fmul_rn(v.w, sx), wv.w);
    *reinterpret_cast<float4*>(y + (size_t)(m0 + ml) * N + n) = r;
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

// (outer, inner) row-major uint8, boxes of (box_outer, 128 inner bytes)
// with the 128-byte swizzle
bool map_u8(CUtensorMap* map, const void* p, int outer, int inner, int box_outer) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {128u, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int T>
cudaError_t launch_t(const CUtensorMap& xm, const CUtensorMap& wm, const float* xs,
                     const float* ws, float* y, int M, int N, int K, cudaStream_t st) {
  auto kern = int8_gemm_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::SMEM);
  if (err == cudaSuccess)  // all of the SM's L1/shared memory as shared
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + T - 1) / T);
  kern<<<grid, THREADS, Ring<T>::SMEM, st>>>(xm, wm, xs, ws, y, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// xq (M, K) and wq (K, N) int8 row-major, xs (M, 1) and ws (1, N) fp32,
// y (M, N) fp32; K % 16 == 0 and N % 16 == 0 (TMA's 16-byte row strides:
// the wrapper pads), all pointers 16-byte aligned; T the tokens per CTA
// (32, 64, 128 or 256).
extern "C" int int8_gemm_launch(const void* xq, const void* wq, const void* xs,
                                const void* ws, void* y, int M, int N, int K, int T,
                                void* stream) {
  const uintptr_t al = reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq) |
                       reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(y);
  if (M < 1 || N < 1 || K < 1 || K % 16 != 0 || N % 16 != 0 || (al & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  if (!map_u8(&xm, xq, M, K, T) || !map_u8(&wm, wq, K, N, KS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xsp = static_cast<const float*>(xs);
  const float* wsp = static_cast<const float*>(ws);
  float* yp = static_cast<float*>(y);
  switch (T) {
    case 32: return (int)launch_t<32>(xm, wm, xsp, wsp, yp, M, N, K, st);
    case 64: return (int)launch_t<64>(xm, wm, xsp, wsp, yp, M, N, K, st);
    case 128: return (int)launch_t<128>(xm, wm, xsp, wsp, yp, M, N, K, st);
    case 256: return (int)launch_t<256>(xm, wm, xsp, wsp, yp, M, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
