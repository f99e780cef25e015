// Sort of 2-word keys for Hopper (sm_90a).
//
// Replaces mitoflex_tpu/ops/psort.py::bitonic_sort2: the Pallas
// _sort_tile_kernel and _finish_tile_kernel (through _tile_call) between the
// XLA _cross_butterfly stages. Contract: n keys given as two uint32 words
// (w0 [n] then w1 [n], word-major), sorted ascending by (w0, w1); keys
// only, so the output is fully determined by the input. Any n.
//
// What bounds it on the H100: device-memory bytes per pass, so the design
// makes the passes few and each one cheap.
// - Block sort in registers: a block of kSortThreads threads sorts a tile
//   of kSortTile = 8192 keys. Each thread loads kPerThread = 16 keys with
//   16-byte loads (coalesced; which keys a thread holds does not matter
//   before they are sorted), packs each as (w0 << 32) | w1 in one uint64,
//   and sorts its 16 with a fixed bitonic network on registers. The
//   thread runs then merge pairwise in shared memory, log2(512) = 9 levels:
//   a thread finds the merge-path start of its 16 outputs by a binary
//   search and merges them serially with both head keys in registers. The
//   shared tile skips one slot in 17, so that the 16-key runs of a warp's
//   threads start in different banks. The ragged last tile is padded with
//   all-ones keys, which sort last and are not written back.
// - Intermediate buffers hold packed uint64 keys, one 8-byte access per
//   key; only the first read and the last write use the word-major layout.
// - log2(n / kSortTile) passes merge adjacent sorted runs pairwise with the
//   merge-path tile of merge_path.cuh on 64-bit words (warp-wide partition
//   search, asynchronous staged loads, 16 outputs a thread). A pass is one
//   launch over all the pairs of its level. The passes ping-pong between
//   the output buffer (used as packed scratch until the last pass) and one
//   scratch buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kSortThreads = 512;
constexpr int kPerThread = 16;
constexpr int kSortTile = kSortThreads * kPerThread;
constexpr int kSortSmemBytes = (kSortTile + kSortTile / 16) * 8;
constexpr int kPassRows = mfx::merge_tile_rows(8);
constexpr int kPassBlocksPerSm = 3;

static_assert(kSortTile % kPassRows == 0, "a pass tile must not straddle runs");

// slot of logical element e in the padded shared tile
__device__ __forceinline__ int slot(int e) { return e + (e >> 4); }

__device__ __forceinline__ u64 pack(uint32_t w0, uint32_t w1) {
  return ((u64)w0 << 32) | (u64)w1;
}

__device__ __forceinline__ void compare_exchange(u64& x, u64& y, bool asc) {
  if ((x > y) == asc) {
    const u64 t = x;
    x = y;
    y = t;
  }
}

// Sorts tile blockIdx.x of the word-major input. The sorted tile goes to
// out_packed as uint64 keys, or, when out_words is not null (n fits one
// tile), straight to the word-major output.
__global__ void __launch_bounds__(kSortThreads)
    block_sort_kernel(const uint32_t* __restrict__ in, int64_t n,
                      u64* __restrict__ out_packed,
                      uint32_t* __restrict__ out_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s = reinterpret_cast<u64*>(smem);
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kSortTile;
  const int rows = (int)min((int64_t)kSortTile, n - base);
  const uint32_t* w0 = in + base;
  const uint32_t* w1 = in + n + base;
  u64 x[kPerThread];
  const bool vec =
      rows == kSortTile && (((uintptr_t)w0 | (uintptr_t)w1) & 15) == 0;
#pragma unroll
  for (int j = 0; j < kPerThread / 4; ++j) {
    const int e = (j * kSortThreads + tid) * 4;
    if (vec) {
      const uint4 a = *reinterpret_cast<const uint4*>(w0 + e);
      const uint4 b = *reinterpret_cast<const uint4*>(w1 + e);
      x[4 * j + 0] = pack(a.x, b.x);
      x[4 * j + 1] = pack(a.y, b.y);
      x[4 * j + 2] = pack(a.z, b.z);
      x[4 * j + 3] = pack(a.w, b.w);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[4 * j + q] = e + q < rows ? pack(w0[e + q], w1[e + q]) : ~0ull;
    }
  }
  // bitonic network on the thread's registers
#pragma unroll
  for (int k = 2; k <= kPerThread; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int l = i ^ j;
        if (l > i) compare_exchange(x[i], x[l], (i & k) == 0);
      }
    }
  }
  const int first = tid * kPerThread;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) s[slot(first + i)] = x[i];
  __syncthreads();
  // merge runs of len keys pairwise; this thread's outputs are
  // [first, first + kPerThread) of the tile
  for (int len = kPerThread; len < kSortTile; len <<= 1) {
    const int start = first / (2 * len) * (2 * len);  // run A; B at + len
    const int diag = first - start;
    int lo = max(0, diag - len);
    int hi = min(diag, len);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[slot(start + mid)] > s[slot(start + len + diag - 1 - mid)]) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    int ai = lo;
    int bi = diag - lo;
    u64 ka = ai < len ? s[slot(start + ai)] : ~0ull;
    u64 kb = bi < len ? s[slot(start + len + bi)] : ~0ull;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const bool take_a = ai < len && (bi >= len || ka <= kb);
      x[i] = take_a ? ka : kb;
      if (take_a) {
        ++ai;
        if (ai < len) ka = s[slot(start + ai)];
      } else {
        ++bi;
        if (bi < len) kb = s[slot(start + len + bi)];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[slot(first + i)] = x[i];
    __syncthreads();
  }
  for (int r = tid; r < rows; r += kSortThreads) {
    const u64 v = s[slot(r)];
    if (out_words != nullptr) {
      out_words[base + r] = (uint32_t)(v >> 32);
      out_words[n + base + r] = (uint32_t)v;
    } else {
      out_packed[base + r] = v;
    }
  }
}

// One merge level over packed keys: runs of w keys (w a multiple of
// kPassRows), the pair [base, base + w) and [base + w, base + 2w) cut at n;
// tile g covers the output rows [g * kPassRows, (g + 1) * kPassRows).
struct PassPairs {
  const u64* in;
  int64_t n, w;
  __device__ mfx::Tile<u64> operator()(int64_t g) const {
    const int64_t g0 = g * kPassRows;
    const int64_t base = g0 / (2 * w) * (2 * w);
    const int64_t na = min(w, n - base);
    const int64_t nb = max((int64_t)0, min(w, n - base - w));
    const int64_t d0 = g0 - base;
    return {in + base, nullptr, in + base + na, nullptr, /*sa=*/0, na,
            /*sb=*/0,  nb,      d0, min(d0 + kPassRows, na + nb),
            /*out_off=*/g0};
  }
};

struct StorePacked {
  u64* out;
  __device__ void operator()(int, int64_t row, u64 v) const { out[row] = v; }
};

// the last pass: back to the word-major layout
struct StoreWordMajor {
  uint32_t* out;
  int64_t n;
  __device__ void operator()(int, int64_t row, u64 v) const {
    out[row] = (uint32_t)(v >> 32);
    out[n + row] = (uint32_t)v;
  }
};

template <class Store>
__global__ void __launch_bounds__(mfx::kMergeThreads, kPassBlocksPerSm)
    sort_merge_pass_kernel(PassPairs pairs, Store store, int64_t n_tiles,
                           int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  mfx::merge_tiles<u64>(smem, 1, 1, kPassRows, n_tiles, chunk, pairs, store);
}

template <class Store>
cudaError_t launch_pass(const u64* in, int64_t n, int64_t w, Store store,
                        int64_t n_tiles, cudaStream_t s) {
  static int setup[mfx::kMaxDevices];  // one per Store
  const size_t smem = mfx::merge_smem_bytes<u64>(1, kPassRows);
  int sms = 0;
  const cudaError_t err = mfx::kernel_setup(sort_merge_pass_kernel<Store>,
                                            (int)smem, setup, &sms);
  if (err != cudaSuccess) return err;
  const mfx::Chunks c = mfx::merge_chunks(n_tiles, sms * kPassBlocksPerSm);
  const PassPairs pairs = {in, n, w};
  sort_merge_pass_kernel<Store><<<c.blocks, mfx::kMergeThreads, smem, s>>>(
      pairs, store, n_tiles, c.chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mfx_sort_tile_rows() { return kSortTile; }

// in, scratch and out: [2, n] word-major uint32; in is not written. scratch
// and out must be 16-byte aligned (they hold packed keys between passes).
extern "C" int mfx_sort_words2(const void* in, int64_t n, void* scratch,
                               void* out, void* stream) {
  if (n < 0 || (((uintptr_t)scratch | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int passes = 0;
  for (int64_t w = kSortTile; w < n; w <<= 1) ++passes;
  // the last pass reads scratch and writes out, so the block sort writes
  // scratch when the number of passes is odd
  u64* bufs[2] = {(u64*)out, (u64*)scratch};
  int cur = passes & 1;
  static int setup[mfx::kMaxDevices];
  int sms = 0;
  cudaError_t err =
      mfx::kernel_setup(block_sort_kernel, kSortSmemBytes, setup, &sms);
  if (err != cudaSuccess) return (int)err;
  block_sort_kernel<<<(unsigned)((n + kSortTile - 1) / kSortTile), kSortThreads,
                      kSortSmemBytes, s>>>(
      (const uint32_t*)in, n, bufs[cur], passes == 0 ? (uint32_t*)out : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || passes == 0) return (int)err;
  const int64_t n_tiles = (n + kPassRows - 1) / kPassRows;
  int64_t w = kSortTile;
  for (int p = 0; p < passes; ++p, w <<= 1, cur ^= 1) {
    if (p + 1 < passes) {
      err = launch_pass(bufs[cur], n, w, StorePacked{bufs[cur ^ 1]}, n_tiles,
                        s);
    } else {
      err = launch_pass(bufs[cur], n, w, StoreWordMajor{(uint32_t*)out, n},
                        n_tiles, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
