// The merge-path tile: device code shared by the sorted-run merges of
// merge.cu (K2, K3) and the merge passes of sort.cu (K4).
//
// A run is W key words plus P payload words per row, stored word-major:
// word w of row i at keys[w * stride + i], payload p at
// pays[p * stride + i]. Words are of type T: uint32_t for the k-mer runs,
// uint64_t (one packed word, W = 1, P = 0) for the key sort. Rows compare
// by their key words in unsigned lexicographic order; equal keys take run
// A's rows first.
//
// What bounds a merge on the H100 is device-memory bytes, so the tile is
// built to keep loads in flight and to spend few instructions per row:
// - One launch. A block walks through a chunk of consecutive output tiles
//   of R rows (R falls as the row widens, so that two blocks fit an SM). It
//   first finds the merge-path split of every tile boundary of its chunk
//   itself, all at once: a group of lanes (a whole warp where the chunk is
//   short, fewer lanes where it is long) probes several points of a
//   diagonal per step (word 0 first, deeper words only on ties), so a
//   search takes a few dependent loads instead of log2 n, and the searches
//   of a chunk overlap each other.
// - Asynchronous, staged loads. The tile's slices of A and B (contiguous
//   per word) go to shared memory with cp.async, 16 bytes at a time where
//   the source is aligned (each slice is placed at the source's own
//   misalignment, so that source and destination align together) and one
//   element at the ragged ends. Two stages: tile i + 1 loads while tile
//   i merges.
// - Several outputs a thread. A thread takes R / kMergeThreads consecutive
//   outputs, does one binary search in shared memory for its start, then
//   merges serially with word 0 of both head rows in registers. It records
//   only the source row of each output; the block then writes word by word
//   through that index, so that a warp's stores land on consecutive
//   addresses. All indices inside a tile are 32 bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mfx {

constexpr int kMaxWords = 16;       // key words
constexpr int kMaxPays = 4;         // payload words
constexpr int kMergeThreads = 256;  // threads of a merging block
constexpr int kStageSlack = 8;      // spare elements per staged word row
constexpr int kMaxChunk = 256;      // tiles a block walks through

// Output rows per tile for rows of `row_bytes` (key and payload words
// together): a stage stays under 48 KB, two stages and the index under
// 112 KB, so two blocks fit the 227 KB of an SM.
__host__ __device__ constexpr int merge_tile_rows(int row_bytes) {
  return row_bytes <= 12 ? 4096 : row_bytes <= 24 ? 2048
         : row_bytes <= 48 ? 1024 : 512;
}

// Dynamic shared memory of merge_tiles: two stages of nw word rows, then
// the 16-bit source index of every output row.
template <typename T>
__host__ __device__ constexpr size_t merge_smem_bytes(int nw, int R) {
  return (size_t)2 * nw * (R + kStageSlack) * sizeof(T) + (size_t)R * 2;
}

constexpr int kMaxDevices = 64;

// Per-device set-up of a kernel at its first launch on the current device:
// raises its dynamic shared memory limit to smem_bytes and reads the SM
// count, which later launches take from `cache` (kMaxDevices zeroed ints,
// one array per kernel).
template <class Kernel>
inline cudaError_t kernel_setup(Kernel kernel, int smem_bytes, int* cache,
                                int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    cache[dev] = n;
  }
  *sms = cache[dev];
  return cudaSuccess;
}

// How a launch cuts n_tiles into blocks: every block takes `chunk`
// consecutive tiles, as few as fill `slots` resident blocks.
struct Chunks {
  unsigned blocks;
  int chunk;
};

inline Chunks merge_chunks(int64_t n_tiles, int slots) {
  int64_t chunk = (n_tiles + slots - 1) / slots;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  if (chunk < 1) chunk = 1;
  return {(unsigned)((n_tiles + chunk - 1) / chunk), (int)chunk};
}

// One output tile: outputs [d0, d1) of the merge of run A (na rows, word
// stride sa) and run B (nb rows, word stride sb), written at output rows
// out_off + (0 .. d1 - d0).
template <typename T>
struct Tile {
  const T* a_keys;
  const T* a_pays;
  const T* b_keys;
  const T* b_pays;
  int64_t sa, na, sb, nb;
  int64_t d0, d1;
  int64_t out_off;
};

// a[w * sa + ia] > b[w * sb + ib], lexicographic over W unsigned words
template <typename T>
__device__ __forceinline__ bool row_greater(const T* __restrict__ a, int64_t sa,
                                            int64_t ia,
                                            const T* __restrict__ b, int64_t sb,
                                            int64_t ib, int W) {
  for (int w = 0; w < W; ++w) {
    const T x = a[w * sa + ia];
    const T y = b[w * sb + ib];
    if (x != y) return x > y;
  }
  return false;
}

// Number of A rows among the first d outputs: the first a in
// [max(0, d - nb), min(d, na)] with A[a] > B[d - 1 - a] (ties take A).
// A group of G consecutive lanes (G a power of two up to 32) searches one
// diagonal together: each step its lanes probe G evenly spaced points of
// the remaining range, which shrinks to one part in G + 1 (G = 1 is a
// binary search). All 32 lanes of the warp must call, with the same G;
// the lanes of a group pass the same arguments and all get the result. A
// group with nothing to search passes na = nb = 0.
template <typename T>
__device__ __forceinline__ int64_t group_split(const T* __restrict__ a,
                                               int64_t sa, int64_t na,
                                               const T* __restrict__ b,
                                               int64_t sb, int64_t nb, int W,
                                               int64_t d, int G) {
  const int lane = threadIdx.x & 31;
  const int in_group = lane & (G - 1);
  const int group_shift = lane - in_group;
  const unsigned group_mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  int64_t lo = max((int64_t)0, d - nb);
  int64_t hi = min(d, na);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int64_t step = (hi - lo + G) / (G + 1);
    const int64_t p = lo + (in_group + 1) * step - 1;
    const bool above =
        lo < hi && (p >= hi || row_greater(a, sa, p, b, sb, d - 1 - p, W));
    const unsigned m =
        (__ballot_sync(0xffffffffu, above) >> group_shift) & group_mask;
    if (lo < hi) {
      const int f = m ? __ffs(m) - 1 : G;
      lo += f * step;
      if (f < G) hi = min(hi, lo + step - 1);
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block-wide asynchronous copy of count elements; dst and src must have
// the same offset within 16 bytes.
template <typename T>
__device__ __forceinline__ void async_copy(T* dst, const T* __restrict__ src,
                                           int count) {
  constexpr int E = 16 / sizeof(T);
  const int mis = (int)(((uintptr_t)src / sizeof(T)) % E);
  const int head = min((E - mis) % E, count);
  const int body = (count - head) / E;
  const int tail = head + body * E;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    cp_async_small<sizeof(T)>(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async_16(dst + head + i * E, src + head + i * E);
  for (int i = tail + threadIdx.x; i < count; i += blockDim.x)
    cp_async_small<sizeof(T)>(dst + i, src + i);
}

// Shared state of one block of merge_tiles, beside its dynamic memory.
struct MergeShared {
  int off[2][2][kMaxWords + kMaxPays];  // [stage][run][word] -> row 0
  int64_t cut[kMaxChunk + 1];           // A rows before tile j's first output
};

// A rows of the pair before tile t's last output, given the cut of the
// block's next tile (which starts there unless t ends its pair).
template <typename T>
__device__ __forceinline__ int64_t tile_end_cut(const Tile<T>& t,
                                                int64_t next_cut) {
  return t.d1 == t.na + t.nb ? t.na : next_cut;
}

// Start the loads of tile t's slices (A rows [a0, a1) and the B rows that
// go with them) into stage k. Ends with a committed cp.async group on
// every thread.
template <typename T>
__device__ __forceinline__ void merge_tile_load(const Tile<T>& t, int64_t a0,
                                                int64_t a1, int W, int nw,
                                                int R, T* stage,
                                                MergeShared& sh, int k) {
  constexpr int E = 16 / sizeof(T);
  const int RS = R + kStageSlack;
  const int64_t b0 = t.d0 - a0;
  const int la = (int)(a1 - a0);
  const int lb = (int)(t.d1 - t.d0) - la;
  if (threadIdx.x < nw) {
    const int w = threadIdx.x;
    const T* pa = (w < W ? t.a_keys + w * t.sa : t.a_pays + (w - W) * t.sa) + a0;
    const T* pb = (w < W ? t.b_keys + w * t.sb : t.b_pays + (w - W) * t.sb) + b0;
    const int ma = (int)(((uintptr_t)pa / sizeof(T)) % E);
    const int mb = (int)(((uintptr_t)pb / sizeof(T)) % E);
    const int oa = w * RS + ma;
    sh.off[k][0][w] = oa;
    sh.off[k][1][w] = oa + la + ((mb - ma - la) & (E - 1));
  }
  __syncthreads();
  T* st = stage + (size_t)k * nw * RS;
  for (int w = 0; w < nw; ++w) {
    const T* pa = (w < W ? t.a_keys + w * t.sa : t.a_pays + (w - W) * t.sa) + a0;
    const T* pb = (w < W ? t.b_keys + w * t.sb : t.b_pays + (w - W) * t.sb) + b0;
    async_copy(st + sh.off[k][0][w], pa, la);
    async_copy(st + sh.off[k][1][w], pb, lb);
  }
  cp_async_commit();
}

// A's staged row ia > B's staged row ib over key words [w0, W)
template <typename T>
__device__ __forceinline__ bool staged_greater(const T* st, const int* off_a,
                                               const int* off_b, int ia, int ib,
                                               int w0, int W) {
  for (int w = w0; w < W; ++w) {
    const T x = st[off_a[w] + ia];
    const T y = st[off_b[w] + ib];
    if (x != y) return x > y;
  }
  return false;
}

// Merge the tile staged in stage k (la rows of A, the rest of B) and write
// its rows out through store(word, output row, value).
template <typename T, class Store>
__device__ __forceinline__ void merge_tile_emit(const Tile<T>& t, int la, int W,
                                                int nw, int R, const T* stage,
                                                uint16_t* idx,
                                                const MergeShared& sh, int k,
                                                const Store& store) {
  const int RS = R + kStageSlack;
  const T* st = stage + (size_t)k * nw * RS;
  const int* off_a = sh.off[k][0];
  const int* off_b = sh.off[k][1];
  const int rows = (int)(t.d1 - t.d0);
  const int lb = rows - la;
  const int per = R / kMergeThreads;
  const int i0 = threadIdx.x * per;
  if (i0 < rows) {
    int lo = max(0, i0 - lb);
    int hi = min(i0, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (staged_greater(st, off_a, off_b, mid, i0 - 1 - mid, 0, W)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    int ai = lo;
    int bi = i0 - lo;
    const int oa = off_a[0];
    const int ob = off_b[0];
    T ka = ai < la ? st[oa + ai] : (T)0;
    T kb = bi < lb ? st[ob + bi] : (T)0;
    const int i1 = min(i0 + per, rows);
    for (int i = i0; i < i1; ++i) {
      bool take_a;
      if (ai >= la) {
        take_a = false;
      } else if (bi >= lb) {
        take_a = true;
      } else if (ka != kb) {
        take_a = ka < kb;
      } else {
        take_a = !staged_greater(st, off_a, off_b, ai, bi, 1, W);
      }
      if (take_a) {
        idx[i] = (uint16_t)ai;
        ++ai;
        if (ai < la) ka = st[oa + ai];
      } else {
        idx[i] = (uint16_t)(la + bi);
        ++bi;
        if (bi < lb) kb = st[ob + bi];
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int c = idx[r];
    const int* off = c < la ? off_a : off_b;
    const int j = c < la ? c : c - la;
    for (int w = 0; w < nw; ++w) store(w, t.out_off + r, st[off[w] + j]);
  }
}

// The block's loop over its chunk of tiles: tiles [blockIdx.x * chunk,
// (blockIdx.x + 1) * chunk) of n_tiles, chunk <= kMaxChunk; tile_of(g)
// describes tile g. The block first finds the cut of every tile of the
// chunk (a group of lanes each, all in flight together), then runs the two-stage
// load / merge pipeline with no search in its way. smem:
// merge_smem_bytes<T>(nw, R) bytes, 16-byte aligned. blockDim.x must be
// kMergeThreads.
template <typename T, class TileOf, class Store>
__device__ __forceinline__ void merge_tiles(unsigned char* smem, int W, int nw,
                                            int R, int64_t n_tiles, int chunk,
                                            const TileOf& tile_of,
                                            const Store& store) {
  __shared__ MergeShared sh;
  T* stage = reinterpret_cast<T*>(smem);
  uint16_t* idx = reinterpret_cast<uint16_t*>(
      smem + (size_t)2 * nw * (R + kStageSlack) * sizeof(T));
  const int64_t g0 = (int64_t)blockIdx.x * chunk;
  if (g0 >= n_tiles) return;
  const int count = (int)min((int64_t)chunk, n_tiles - g0);
  const int cuts = g0 + count < n_tiles ? count + 1 : count;
  // lanes per search: as many as let all the chunk's searches run at once
  int G = 32;
  while (G > 1 && cuts * G > kMergeThreads) G >>= 1;
  for (int first = 0; first < cuts; first += kMergeThreads / G) {
    // a group beyond the last cut takes part in its warp's votes with an
    // empty search
    const int j = first + threadIdx.x / G;
    const bool live = j < cuts;
    const Tile<T> t = tile_of(g0 + (live ? j : 0));
    const int64_t c = group_split(t.a_keys, t.sa, live ? t.na : 0, t.b_keys, t.sb,
                                  live ? t.nb : 0, W, t.d0, G);
    if (live && (threadIdx.x & (G - 1)) == 0) sh.cut[j] = c;
  }
  if (threadIdx.x == 0 && cuts == count) sh.cut[count] = 0;  // never used
  __syncthreads();
  Tile<T> cur = tile_of(g0);
  int64_t a0 = sh.cut[0];
  int64_t a1 = tile_end_cut(cur, sh.cut[1]);
  merge_tile_load(cur, a0, a1, W, nw, R, stage, sh, 0);
  for (int j = 0, k = 0; j < count; ++j, k ^= 1) {
    Tile<T> next = cur;
    int64_t na0 = 0, na1 = 0;
    if (j + 1 < count) {
      next = tile_of(g0 + j + 1);
      na0 = sh.cut[j + 1];
      na1 = tile_end_cut(next, sh.cut[j + 2]);
      merge_tile_load(next, na0, na1, W, nw, R, stage, sh, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    merge_tile_emit(cur, (int)(a1 - a0), W, nw, R, stage, idx, sh, k, store);
    __syncthreads();
    cur = next;
    a0 = na0;
    a1 = na1;
  }
}

}  // namespace mfx
