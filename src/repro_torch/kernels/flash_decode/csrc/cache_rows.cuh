// Where a decode-attention kernel finds position p of cache row b, in
// cache rows (one row: Hk heads of one position): the contiguous cache
// (B, S, Hk, ...), or a paged cache's block arena (NB, bs, Hk, ...)
// through its (B, W) int32 block table (src/repro_torch/serve/paging.py).
// A table entry is clamped to [0, NB - 1], as the reference's clip gather
// (`jnp.take(..., mode="clip")`): the sentinel NB reads block NB - 1, a
// row the attention mask hides.
#pragma once
#include <stddef.h>

struct ContiguousRows {
  int S;
  __device__ __forceinline__ size_t row(int b, int p) const { return (size_t)b * S + p; }
};

struct PagedRows {
  const int* table;  // (B, W)
  int W, bs, NB;
  __device__ __forceinline__ size_t row(int b, int p) const {
    const int blk = min(max(__ldg(table + (size_t)b * W + p / bs), 0), NB - 1);
    return (size_t)blk * bs + p % bs;
  }
};
