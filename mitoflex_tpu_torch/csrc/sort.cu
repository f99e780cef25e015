// Sort of 2-word keys for Hopper (sm_90a).
//
// Replaces mitoflex_tpu/ops/psort.py::bitonic_sort2: the Pallas
// _sort_tile_kernel and _finish_tile_kernel (through _tile_call) between the
// XLA _cross_butterfly stages. Contract: n keys given as two uint32 words
// (w0 [n] then w1 [n], word-major), sorted ascending by (w0, w1); keys
// only, so the output is fully determined by the input. Any n.
//
// What bounds it on the H100: device-memory bytes per pass. The TPU
// network ran log2(n) stages over memory because a Mosaic block could not
// address data-dependently; here one block sorts a tile of kSortTile keys
// in shared memory (a bitonic network on (w0 << 32) | w1 as one uint64;
// the ragged last tile is padded with all-ones keys, which sort last and
// are not written back), and then log2(n / kSortTile) passes each merge
// adjacent sorted runs pairwise with the merge-path tile of
// merge_path.cuh (no payload words). Each pass is one launch over all the
// pairs of its level: every block finds its own pair and the split of its
// output tile, and reads and writes each key once. The passes ping-pong
// between the output and one scratch buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kSortTile = 2048;
constexpr int kSortThreads = kSortTile / 2;  // one compare-exchange each
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kSortThreads)
    sort_tile_kernel(const uint32_t* __restrict__ in, int64_t n,
                     uint32_t* __restrict__ out) {
  __shared__ unsigned long long s[kSortTile];
  const int64_t base = (int64_t)blockIdx.x * kSortTile;
  const int rows = (int)min((int64_t)kSortTile, n - base);
  for (int r = threadIdx.x; r < kSortTile; r += blockDim.x) {
    s[r] = r < rows ? ((unsigned long long)in[base + r] << 32) |
                          (unsigned long long)in[n + base + r]
                    : ~0ull;
  }
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= kSortTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * t - (t & (j - 1));  // bit j of i is clear
      const bool asc = (i & k) == 0;
      const unsigned long long x = s[i];
      const unsigned long long y = s[i + j];
      if ((x > y) == asc) {
        s[i] = y;
        s[i + j] = x;
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    out[base + r] = (uint32_t)(s[r] >> 32);
    out[n + base + r] = (uint32_t)s[r];
  }
}

// One merge level: runs of w keys (w a multiple of kTile), the pair
// [base, base + w) and [base + w, base + 2w) cut at n; block b writes the
// output rows [b * kTile, (b + 1) * kTile).
__global__ void sort_merge_pass_kernel(const uint32_t* __restrict__ in,
                                       int64_t n, int64_t w,
                                       uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[2 * mfx::kTile];
  __shared__ int64_t cut[2];
  const int64_t g0 = (int64_t)blockIdx.x * mfx::kTile;
  const int64_t base = g0 / (2 * w) * (2 * w);
  const int64_t na = min(w, n - base);
  const int64_t nb = max((int64_t)0, min(w, n - base - w));
  const int64_t d0 = g0 - base;
  const int64_t d1 = min(d0 + mfx::kTile, na + nb);
  const uint32_t* a = in + base;
  const uint32_t* b = in + base + na;
  if (threadIdx.x < 2) {
    cut[threadIdx.x] =
        mfx::merge_path_split(a, n, na, b, n, nb, 2, threadIdx.x ? d1 : d0);
  }
  __syncthreads();
  mfx::merge_tile<0>(tile, a, nullptr, n, na, b, nullptr, n, nb, 2, cut[0],
                     cut[1], d0, d1, out, nullptr, n, g0);
}

}  // namespace

extern "C" int mfx_sort_tile_rows() { return kSortTile; }

// in, scratch and out: [2, n] word-major uint32; in is not written.
extern "C" int mfx_sort_words2(const void* in, int64_t n, void* scratch,
                               void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int passes = 0;
  for (int64_t w = kSortTile; w < n; w <<= 1) ++passes;
  uint32_t* bufs[2] = {(uint32_t*)out, (uint32_t*)scratch};
  int cur = passes & 1;  // so that the last pass writes out
  sort_tile_kernel<<<(unsigned)((n + kSortTile - 1) / kSortTile), kSortThreads,
                     0, s>>>((const uint32_t*)in, n, bufs[cur]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + mfx::kTile - 1) / mfx::kTile);
  for (int64_t w = kSortTile; w < n; w <<= 1) {
    sort_merge_pass_kernel<<<blocks, kMergeThreads, 0, s>>>(bufs[cur], n, w,
                                                           bufs[cur ^ 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
