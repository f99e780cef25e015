// The merge-path tile: device code shared by the sorted-run merges of
// merge.cu (K2, K3) and the merge passes of sort.cu (K4).
//
// A run is W key words plus P payload words per row, stored word-major:
// word w of row i at keys[w * stride + i], payload p at
// pays[p * stride + i]. Rows compare by their key words in unsigned
// lexicographic order; equal keys take run A's rows first.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mfx {

constexpr int kTile = 1024;    // output rows per block
constexpr int kMaxWords = 16;  // key words
constexpr int kMaxPays = 4;    // payload words

// a[w * sa + ia] > b[w * sb + ib], lexicographic over W unsigned words
__device__ __forceinline__ bool key_greater(const uint32_t* a, int64_t sa,
                                            int64_t ia, const uint32_t* b,
                                            int64_t sb, int64_t ib, int W) {
  for (int w = 0; w < W; ++w) {
    const uint32_t x = a[w * sa + ia];
    const uint32_t y = b[w * sb + ib];
    if (x != y) return x > y;
  }
  return false;
}

// Number of A rows among the first d outputs: the first a in
// [max(0, d - nb), min(d, na)] with A[a] > B[d - 1 - a] (ties take A).
__device__ __forceinline__ int64_t merge_path_split(const uint32_t* a,
                                                    int64_t sa, int64_t na,
                                                    const uint32_t* b,
                                                    int64_t sb, int64_t nb,
                                                    int W, int64_t d) {
  int64_t lo = max((int64_t)0, d - nb);
  int64_t hi = min(d, na);
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (key_greater(a, sa, mid, b, sb, d - 1 - mid, W)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Merge the outputs [d0, d1) of runs A and B (d1 - d0 <= kTile), given the
// A rows before each end (a0 at d0, a1 at d1), into output rows
// out_off + (0 .. d1 - d0) of an output of word stride so. The whole block
// takes part; tile is (W + P) * kTile words of shared memory.
template <int P>
__device__ __forceinline__ void merge_tile(
    uint32_t* tile, const uint32_t* __restrict__ a_keys,
    const uint32_t* __restrict__ a_pays, int64_t sa, int64_t na,
    const uint32_t* __restrict__ b_keys, const uint32_t* __restrict__ b_pays,
    int64_t sb, int64_t nb, int W, int64_t a0, int64_t a1, int64_t d0,
    int64_t d1, uint32_t* __restrict__ out_keys,
    uint32_t* __restrict__ out_pays, int64_t so, int64_t out_off) {
  // rows [0, la) are A's slice, [la, la + lb) B's; word w of row r at
  // tile[w * kTile + r], payload p at tile[(W + p) * kTile + r]
  const int64_t b0 = d0 - a0;
  const int la = (int)(a1 - a0);
  const int rows = (int)(d1 - d0);
  const int lb = rows - la;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    if (r < la) {
      for (int w = 0; w < W; ++w) tile[w * kTile + r] = a_keys[w * sa + a0 + r];
#pragma unroll
      for (int p = 0; p < P; ++p)
        tile[(W + p) * kTile + r] = a_pays[p * sa + a0 + r];
    } else {
      const int64_t j = b0 + (r - la);
      for (int w = 0; w < W; ++w) tile[w * kTile + r] = b_keys[w * sb + j];
#pragma unroll
      for (int p = 0; p < P; ++p) tile[(W + p) * kTile + r] = b_pays[p * sb + j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    int lo = max(0, i - lb);
    int hi = min(i, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_greater(tile, kTile, mid, tile, kTile, la + i - 1 - mid, W)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int ai = lo;
    const int bi = i - lo;
    const bool take_a =
        ai < la &&
        (bi >= lb || !key_greater(tile, kTile, ai, tile, kTile, la + bi, W));
    const int src = take_a ? ai : la + bi;
    for (int w = 0; w < W; ++w)
      out_keys[w * so + out_off + i] = tile[w * kTile + src];
#pragma unroll
    for (int p = 0; p < P; ++p)
      out_pays[p * so + out_off + i] = tile[(W + p) * kTile + src];
  }
}

}  // namespace mfx
