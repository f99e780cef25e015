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
// data-dependent addressing), so this is a merge path instead: one pass,
// in one launch. Each block loops over output tiles; for each it finds the
// tile's split of A and B with a warp-wide search, stages the two slices in
// shared memory with asynchronous copies (the next tile loads while this
// one merges), and every thread merges several consecutive outputs
// serially (merge_path.cuh). K2 is the one-payload case of the kernel that
// K3 runs with 0 to 4 payload words; the sort of sort.cu runs the same
// tile code on packed 64-bit keys.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kBlocksPerSm = 2;
constexpr int kMaxSmemBytes = 112 * 1024;  // of any row width; two fit an SM

constexpr bool smem_fits() {
  for (int nw = 1; nw <= mfx::kMaxWords + mfx::kMaxPays; ++nw)
    if (mfx::merge_smem_bytes<uint32_t>(nw, mfx::merge_tile_rows(nw * 4)) >
        (size_t)kMaxSmemBytes)
      return false;
  return true;
}
static_assert(smem_fits(), "a merge tile outgrows kMaxSmemBytes");

struct RunPair {
  const uint32_t* a_keys;
  const uint32_t* a_pays;
  int64_t na;
  const uint32_t* b_keys;
  const uint32_t* b_pays;
  int64_t nb;
  int R;
  __device__ mfx::Tile<uint32_t> operator()(int64_t g) const {
    const int64_t d0 = g * R;
    return {a_keys, a_pays, b_keys, b_pays, /*sa=*/na, na, /*sb=*/nb, nb,
            d0,     min(d0 + R, na + nb), /*out_off=*/d0};
  }
};

struct StoreWords {
  uint32_t* out_keys;
  uint32_t* out_pays;
  int64_t n;
  int W;
  __device__ void operator()(int w, int64_t row, uint32_t v) const {
    if (w < W) {
      out_keys[w * n + row] = v;
    } else {
      out_pays[(w - W) * n + row] = v;
    }
  }
};

__global__ void __launch_bounds__(mfx::kMergeThreads, kBlocksPerSm)
    merge_runs_kernel(RunPair runs, StoreWords store, int W, int nw,
                      int64_t n_tiles, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  mfx::merge_tiles<uint32_t>(smem, W, nw, runs.R, n_tiles, chunk, runs, store);
}

cudaError_t launch(const void* a_keys, const void* a_pays, int64_t na,
                   const void* b_keys, const void* b_pays, int64_t nb, int W,
                   int P, void* out_keys, void* out_pays, cudaStream_t s) {
  const int nw = W + P;
  const int R = mfx::merge_tile_rows(nw * 4);
  const int64_t n = na + nb;
  const int64_t n_tiles = (n + R - 1) / R;
  static int setup[mfx::kMaxDevices];
  int sms = 0;
  const cudaError_t err =
      mfx::kernel_setup(merge_runs_kernel, kMaxSmemBytes, setup, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = mfx::merge_smem_bytes<uint32_t>(nw, R);
  const mfx::Chunks c = mfx::merge_chunks(n_tiles, sms * kBlocksPerSm);
  const RunPair runs = {(const uint32_t*)a_keys, (const uint32_t*)a_pays, na,
                        (const uint32_t*)b_keys, (const uint32_t*)b_pays, nb,
                        R};
  const StoreWords store = {(uint32_t*)out_keys, (uint32_t*)out_pays, n, W};
  merge_runs_kernel<<<c.blocks, mfx::kMergeThreads, smem, s>>>(
      runs, store, W, nw, n_tiles, c.chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mfx_merge_max_words() { return mfx::kMaxWords; }

extern "C" int mfx_merge_max_payloads() { return mfx::kMaxPays; }

// Output rows per tile for rows of W key words and P payload words.
extern "C" int mfx_merge_tile_rows(int W, int P) {
  return mfx::merge_tile_rows((W + P) * 4);
}

// K2: one payload word per row.
extern "C" int mfx_merge_sorted_runs(const void* a_keys, const void* a_vals,
                                     int64_t na, const void* b_keys,
                                     const void* b_vals, int64_t nb, int W,
                                     void* out_keys, void* out_vals,
                                     void* stream) {
  if (W < 1 || W > mfx::kMaxWords) return (int)cudaErrorInvalidValue;
  if (na + nb == 0) return (int)cudaSuccess;
  return (int)launch(a_keys, a_vals, na, b_keys, b_vals, nb, W, 1, out_keys,
                     out_vals, (cudaStream_t)stream);
}

// K3. Payloads are [P, n] word-major arrays (ignored when P == 0).
extern "C" int mfx_merge_sorted_runs_onepass(
    const void* a_keys, const void* a_pays, int64_t na, const void* b_keys,
    const void* b_pays, int64_t nb, int W, int P, void* out_keys,
    void* out_pays, void* stream) {
  if (W < 1 || W > mfx::kMaxWords || P < 0 || P > mfx::kMaxPays)
    return (int)cudaErrorInvalidValue;
  if (na + nb == 0) return (int)cudaSuccess;
  return (int)launch(a_keys, a_pays, na, b_keys, b_pays, nb, W, P, out_keys,
                     out_pays, (cudaStream_t)stream);
}
