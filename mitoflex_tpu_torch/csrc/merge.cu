// Merge of two sorted k-mer runs for Hopper (sm_90a).
//
// Replaces mitoflex_tpu/ops/psort.py::merge_sorted_runs: the Pallas
// _merge_pair_kernel (through _merge_pair_pass) and _merge_finish_kernel
// (through _merge_finish_pass) after one XLA compare stage at stride m.
// Contract: run A (na rows) and run B (nb rows) are each sorted by W key
// words in unsigned lexicographic order; each row carries one 32-bit
// payload. The output is the sorted run of na + nb rows. Equal keys take
// A's rows first. Any run lengths are accepted.
//
// What bounds it on the H100: device-memory bytes. Every row's W key words
// and its payload are read once and written once; the compares are a few
// integer operations per byte. The bitonic network's log2(n) passes over
// memory, and its power-of-two lengths, were Mosaic constraints (no
// data-dependent addressing), so this is a merge path instead: one pass.
// A partition kernel binary-searches, for every tile of kTile outputs, the
// split of the tile's first diagonal between A and B. Each block then
// stages its tile's slices of A and B (at most kTile rows together) in
// shared memory, word-major, and every output row finds its own split by a
// binary search there before it writes its key words and payload; the
// writes of a warp land on consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kMaxWords = 16;

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
__global__ void merge_partition_kernel(const uint32_t* __restrict__ a_keys,
                                       int64_t na,
                                       const uint32_t* __restrict__ b_keys,
                                       int64_t nb, int W, int64_t n_tiles,
                                       int64_t* __restrict__ split) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t d = min(t * kTile, na + nb);
  int64_t lo = max((int64_t)0, d - nb);
  int64_t hi = min(d, na);
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (key_greater(a_keys, na, mid, b_keys, nb, d - 1 - mid, W)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  split[t] = lo;
}

__global__ void merge_tile_kernel(
    const uint32_t* __restrict__ a_keys, const uint32_t* __restrict__ a_vals,
    int64_t na, const uint32_t* __restrict__ b_keys,
    const uint32_t* __restrict__ b_vals, int64_t nb, int W,
    const int64_t* __restrict__ split, uint32_t* __restrict__ out_keys,
    uint32_t* __restrict__ out_vals) {
  // rows [0, la) are A's slice, [la, la + lb) B's; word w of row r at
  // tile[w * kTile + r], the payload at tile[W * kTile + r]
  extern __shared__ uint32_t tile[];
  const int64_t n = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = min(d0 + kTile, n);
  const int64_t a0 = split[blockIdx.x];
  const int64_t b0 = d0 - a0;
  const int la = (int)(split[blockIdx.x + 1] - a0);
  const int rows = (int)(d1 - d0);
  const int lb = rows - la;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    if (r < la) {
      for (int w = 0; w < W; ++w) tile[w * kTile + r] = a_keys[w * na + a0 + r];
      tile[W * kTile + r] = a_vals[a0 + r];
    } else {
      const int64_t j = b0 + (r - la);
      for (int w = 0; w < W; ++w) tile[w * kTile + r] = b_keys[w * nb + j];
      tile[W * kTile + r] = b_vals[j];
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
    for (int w = 0; w < W; ++w) out_keys[w * n + d0 + i] = tile[w * kTile + src];
    out_vals[d0 + i] = tile[W * kTile + src];
  }
}

}  // namespace

extern "C" int mfx_merge_max_words() { return kMaxWords; }

extern "C" int mfx_merge_tile_rows() { return kTile; }

// split: scratch of ceil((na + nb) / kTile) + 1 int64 entries.
extern "C" int mfx_merge_sorted_runs(const void* a_keys, const void* a_vals,
                                     int64_t na, const void* b_keys,
                                     const void* b_vals, int64_t nb, int W,
                                     void* split, void* out_keys,
                                     void* out_vals, void* stream) {
  const int64_t n = na + nb;
  if (W < 1 || W > kMaxWords) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  merge_partition_kernel<<<(unsigned)((n_tiles + 1 + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(
      (const uint32_t*)a_keys, na, (const uint32_t*)b_keys, nb, W, n_tiles,
      (int64_t*)split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(W + 1) * kTile * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_tile_kernel<<<(unsigned)n_tiles, kThreads, smem, s>>>(
      (const uint32_t*)a_keys, (const uint32_t*)a_vals, na,
      (const uint32_t*)b_keys, (const uint32_t*)b_vals, nb, W,
      (const int64_t*)split, (uint32_t*)out_keys, (uint32_t*)out_vals);
  return (int)cudaGetLastError();
}
