// Merge of two sorted k-mer runs for Hopper (sm_90a).
//
// Replaces two TPU kernels of mitoflex_tpu/ops/psort.py:
// - merge_sorted_runs (K2): the Pallas _merge_pair_kernel (through
//   _merge_pair_pass) and _merge_finish_kernel (through _merge_finish_pass)
//   after one XLA compare stage at stride m; one 32-bit payload per row
//   (mfx_merge_sorted_runs);
// - merge_sorted_runs_onepass (K3): the Pallas _mergepath_kernel after the
//   XLA diagonal search _merge_partitions; 0 to kMaxPays payload words per
//   row (mfx_merge_sorted_runs_onepass).
// Contract of both: run A (na rows) and run B (nb rows) are each sorted by
// W key words in unsigned lexicographic order; payload words ride with
// their rows. The output is the sorted run of na + nb rows. Equal keys
// take A's rows first. Any run lengths are accepted.
//
// What bounds it on the H100: device-memory bytes. Every row's W key words
// and P payload words are read once and written once; the compares are a
// few integer operations per byte. The bitonic network's log2(n) passes
// over memory, and its power-of-two lengths, were Mosaic constraints (no
// data-dependent addressing), so this is a merge path instead: one pass.
// A partition kernel binary-searches, for every tile of kTile outputs, the
// split of the tile's first diagonal between A and B. Each block then
// stages its tile's slices of A and B (at most kTile rows together) in
// shared memory, word-major, and every output row finds its own split by a
// binary search there before it writes its key and payload words; the
// writes of a warp land on consecutive addresses. The number of payload
// words is a template parameter, so K2 is the P = 1 instance of the same
// tile code that K3 runs with P = 0..4 (and the sort of sort.cu with
// P = 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;

// Number of A rows among the first d outputs, for every tile boundary.
__global__ void merge_partition_kernel(const uint32_t* __restrict__ a_keys,
                                       int64_t na,
                                       const uint32_t* __restrict__ b_keys,
                                       int64_t nb, int W, int64_t n_tiles,
                                       int64_t* __restrict__ split) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t d = min(t * mfx::kTile, na + nb);
  split[t] = mfx::merge_path_split(a_keys, na, na, b_keys, nb, nb, W, d);
}

template <int P>
__global__ void merge_tile_kernel(const uint32_t* __restrict__ a_keys,
                                  const uint32_t* __restrict__ a_pays,
                                  int64_t na,
                                  const uint32_t* __restrict__ b_keys,
                                  const uint32_t* __restrict__ b_pays,
                                  int64_t nb, int W,
                                  const int64_t* __restrict__ split,
                                  uint32_t* __restrict__ out_keys,
                                  uint32_t* __restrict__ out_pays) {
  extern __shared__ uint32_t tile[];
  const int64_t n = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * mfx::kTile;
  const int64_t a0 = split[blockIdx.x];
  mfx::merge_tile<P>(tile, a_keys, a_pays, na, na, b_keys, b_pays, nb, nb, W,
                     a0, split[blockIdx.x + 1], d0, min(d0 + mfx::kTile, n),
                     out_keys, out_pays, n, d0);
}

template <int P>
cudaError_t launch(const void* a_keys, const void* a_pays, int64_t na,
                   const void* b_keys, const void* b_pays, int64_t nb, int W,
                   void* split, void* out_keys, void* out_pays,
                   cudaStream_t s) {
  const int64_t n = na + nb;
  const int64_t n_tiles = (n + mfx::kTile - 1) / mfx::kTile;
  merge_partition_kernel<<<(unsigned)((n_tiles + 1 + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(
      (const uint32_t*)a_keys, na, (const uint32_t*)b_keys, nb, W, n_tiles,
      (int64_t*)split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(W + P) * mfx::kTile * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_tile_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_tile_kernel<P><<<(unsigned)n_tiles, kThreads, smem, s>>>(
      (const uint32_t*)a_keys, (const uint32_t*)a_pays, na,
      (const uint32_t*)b_keys, (const uint32_t*)b_pays, nb, W,
      (const int64_t*)split, (uint32_t*)out_keys, (uint32_t*)out_pays);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mfx_merge_max_words() { return mfx::kMaxWords; }

extern "C" int mfx_merge_max_payloads() { return mfx::kMaxPays; }

extern "C" int mfx_merge_tile_rows() { return mfx::kTile; }

// K2. split: scratch of ceil((na + nb) / kTile) + 1 int64 entries.
extern "C" int mfx_merge_sorted_runs(const void* a_keys, const void* a_vals,
                                     int64_t na, const void* b_keys,
                                     const void* b_vals, int64_t nb, int W,
                                     void* split, void* out_keys,
                                     void* out_vals, void* stream) {
  if (W < 1 || W > mfx::kMaxWords) return (int)cudaErrorInvalidValue;
  if (na + nb == 0) return (int)cudaSuccess;
  return (int)launch<1>(a_keys, a_vals, na, b_keys, b_vals, nb, W, split,
                        out_keys, out_vals, (cudaStream_t)stream);
}

// K3. Payloads are [P, n] word-major arrays (ignored when P == 0); split as
// for K2.
extern "C" int mfx_merge_sorted_runs_onepass(
    const void* a_keys, const void* a_pays, int64_t na, const void* b_keys,
    const void* b_pays, int64_t nb, int W, int P, void* split, void* out_keys,
    void* out_pays, void* stream) {
  if (W < 1 || W > mfx::kMaxWords || P < 0 || P > mfx::kMaxPays)
    return (int)cudaErrorInvalidValue;
  if (na + nb == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 0:
      return (int)launch<0>(a_keys, a_pays, na, b_keys, b_pays, nb, W, split,
                            out_keys, out_pays, s);
    case 1:
      return (int)launch<1>(a_keys, a_pays, na, b_keys, b_pays, nb, W, split,
                            out_keys, out_pays, s);
    case 2:
      return (int)launch<2>(a_keys, a_pays, na, b_keys, b_pays, nb, W, split,
                            out_keys, out_pays, s);
    case 3:
      return (int)launch<3>(a_keys, a_pays, na, b_keys, b_pays, nb, W, split,
                            out_keys, out_pays, s);
    default:
      return (int)launch<4>(a_keys, a_pays, na, b_keys, b_pays, nb, W, split,
                            out_keys, out_pays, s);
  }
}
