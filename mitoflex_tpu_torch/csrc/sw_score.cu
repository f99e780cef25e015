// Score-only Smith-Waterman for Hopper (sm_90a): the best local score of
// every (query, target) pair of a call, in one launch.
//
// Replaces no TPU kernel: the JAX package scores and traces every blastn
// pair with one sw_align scan (mitoflex_tpu/ops/sw.py sw_align :60). The
// port's blastn (models/blast.py) scores every pair with this kernel
// first, drops the rows whose e-value fails the cut (which reads the score
// alone), and sends only the rest through the path kernel of csrc/sw.cu.
// Its plain version is ops/sw.py sw_scores_plain.
//
// The recurrence is sw_align's (ops/sw.py) without the path fields, in
// int32: per streamed position t and lane column j,
//   E[t,j]  = max(H[t-1,j] - open, E[t-1,j] - ext)
//   H'[t,j] = max(H[t-1,j-1] + s, E[t,j])      (H >= 0, so the clamp is moot)
//   F[t,j]  = max(H'[t,j-1] - open, F[t,j-1] - ext)
//   H[t,j]  = max(H'[t,j], F[t,j], 0)
// and the answer is the largest H. With gap_open >= gap_extend this is
// Gotoh's recurrence (opening a gap from H instead of H' differs only where
// the gap could not beat extending one), whose H is the transpose when the
// two sequences swap places, given a symmetric table: so the maximum does
// not depend on which side lies along the lanes. The wrapper refuses an
// asymmetric table and gap_extend > gap_open. With integer scores below
// 2^24 (the wrapper checks the table's largest entry times Lq) every value
// is exact in float32 too, so the score is bit-equal to sw_align's.
//
// What bounds it on the H100: int32 work, 10 operations a cell (the
// substitution score 2, E 2, H' 1, H 1, F 2, the best 1, the diagonal's
// move 1; ops/sw.py SCORE_OPS_PER_CELL) at 132 SMs x 64 int32 lanes x
// 1.98 GHz, 16.7 TOP/s. The inputs are a byte a position, so device memory is no
// limit.
//
// Design (CUDASW++ 4.0's shape): a warp takes a whole pair. The pair's
// shorter side lies along the lanes, C columns to a lane (a tile of 32 C),
// in registers; the longer side streams through the lanes as an
// anti-diagonal wavefront, lane l at position t - l in step t, each lane
// handing the F leaving its last column and that column's H to lane l + 1
// by __shfl_up_sync. The streamed codes come in 32-position chunks, a
// chunk ahead. A side longer than a tile takes tiles one after another: the
// last lane writes the tile's right boundary (F, H) a position into the
// warp's slice of scratch, and the next tile's lane 0 reads it back in
// prefetched chunks. So that a slice of Lq positions always holds the
// boundary, the streamed side is the query wherever the target is longer
// than Lq (the queries' width). Full tiles take 16 columns a lane, a last
// tile 8 or 4 where that covers it. Columns past the side's end never match
// (compare) or score -2^24 (table), so their cells stay below the best
// cell before them and need no mask. H, E and F are int32 with no path
// words; H', F and E each take one DPX add-max (__viaddmax_s32) and H one
// max with 0 (__vimax_s32_relu). The DNA table (matches on the diagonal but
// for the last letter, N; one mismatch score elsewhere) is a compare;
// another symmetric table of up to 32 letters is read from shared memory.
// The grid is persistent, as many blocks of 8 warps as are resident (fewer
// where the scratch would pass the wrapper's cap); warps take pairs from an
// atomic counter in the order the wrapper gives, most cells first, so the
// tail is the shortest pairs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;                   // warps a block
constexpr int kThreads = kLanes * kWarps;
constexpr int kMaxK = 32;                   // letters of a table
constexpr int kCols = 16;                   // columns a lane in a full tile
constexpr int kNeg = -(1 << 30);            // E and F before any cell
constexpr int kLimit = 1 << 24;             // |entries|, gap costs and scores below
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int8_t* queries;     // [Q, Lq]
  const int32_t* q_lens;     // [Q]
  const int64_t* q_index;    // [B]
  const int8_t* targets;     // [T], the pairs' targets end to end
  const int64_t* t_offsets;  // [B + 1]
  const int64_t* order;      // [B]: the pairs, most cells first
  const int32_t* sub;        // [K, K]
  int K, Q, B, Lq;
  int64_t T;
  int go, ge;
  int match, mismatch;       // the compare form's two scores
  int2* scratch;             // [warps, Lq]: (F, H) leaving a tile
  int* next;                 // the work counter, 0 at launch
  float* out;                // [B]
};

// Hopper's DPX instructions (CUDA 12); plain maxima before
__device__ __forceinline__ int addmax(int a, int b, int c) {  // max(a + b, c)
#if __CUDACC_VER_MAJOR__ >= 12
  return __viaddmax_s32(a, b, c);
#else
  return max(a + b, c);
#endif
}

__device__ __forceinline__ int max0(int a, int b) {  // max(a, b, 0)
#if __CUDACC_VER_MAJOR__ >= 12
  return __vimax_s32_relu(a, b);
#else
  return max(max(a, b), 0);
#endif
}

__device__ __forceinline__ int clampk(int c, int K) { return min(max(c, 0), K - 1); }

// a streamed code: compare form, the last letter -2 (it matches nothing);
// table form, the letter
template <bool CMP>
__device__ __forceinline__ int stream_code(int8_t c, int K) {
  const int x = clampk(c, K);
  return CMP ? (x == K - 1 ? -2 : x) : x;
}

// one tile of C columns a lane: columns col0 + 32 C of ``cols`` against
// every position of ``rows``; reads the left boundary from ``scr`` unless
// ``first``, writes the right one there unless ``last``; returns the lane's
// best H
template <int C, bool CMP>
__device__ __forceinline__ int sweep(const Args& a, const int* tab, const int8_t* cols,
                                     int ncols, int col0, const int8_t* rows, int nrows,
                                     bool first, bool last, int2* scr, int lane) {
  const int K = a.K;
  int code[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = col0 + lane * C + c;
    const int q = j < ncols ? clampk(cols[j], K) : -1;
    // compare form: the code, -1 for the last letter and past the end;
    // table form: the table row's offset, row K (all -2^24) past the end
    code[c] = CMP ? (q == K - 1 ? -1 : q) : (q < 0 ? K : q) * K;
    H[c] = 0;
    E[c] = kNeg;
  }
  int best = 0, x = 0, fout = kNeg, hout = 0, hprev = 0;
  int xcur = 0, xnxt = 0;
  int2 bcur = make_int2(kNeg, 0), bnxt = bcur;
  if (lane < nrows) xcur = stream_code<CMP>(rows[lane], K);
  if (kLanes + lane < nrows) xnxt = stream_code<CMP>(rows[kLanes + lane], K);
  if (!first) {
    if (lane < nrows) bcur = scr[lane];
    if (kLanes + lane < nrows) bnxt = scr[kLanes + lane];
  }
  const int steps = nrows + kLanes - 1;
  for (int s = 0; s < steps; ++s) {
    const int t = s - lane;
    const int xu = __shfl_up_sync(kFull, x, 1);
    const int x0 = __shfl_sync(kFull, xcur, s & (kLanes - 1));
    const int fu = __shfl_up_sync(kFull, fout, 1);
    const int hu = __shfl_up_sync(kFull, hout, 1);
    int f0 = kNeg, h0 = 0;
    if (!first) {
      f0 = __shfl_sync(kFull, bcur.x, s & (kLanes - 1));
      h0 = __shfl_sync(kFull, bcur.y, s & (kLanes - 1));
    }
    x = lane == 0 ? x0 : xu;
    if (t >= 0 && t < nrows) {
      int f = lane == 0 ? f0 : fu;
      int diag = hprev;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int sc = CMP ? (code[c] == x ? a.match : a.mismatch) : tab[code[c] + x];
        const int up = H[c];
        const int e = addmax(E[c], -a.ge, up - a.go);
        const int hp = addmax(diag, sc, e);
        const int h = max0(hp, f);
        f = addmax(f, -a.ge, hp - a.go);
        best = max(best, h);
        diag = up;
        E[c] = e;
        H[c] = h;
      }
      fout = f;
      hout = H[C - 1];
      hprev = lane == 0 ? h0 : hu;
      if (!last && lane == kLanes - 1) scr[t] = make_int2(fout, hout);
    }
    if ((s & (kLanes - 1)) == kLanes - 1) {
      // the chunk after next: positions 32 m .. 32 m + 31
      const int r = ((s >> 5) + 2) * kLanes + lane;
      xcur = xnxt;
      xnxt = r < nrows ? stream_code<CMP>(rows[r], K) : 0;
      if (!first) {
        bcur = bnxt;
        bnxt = r < nrows ? scr[r] : make_int2(kNeg, 0);
      }
    }
  }
  __syncwarp();
  return best;
}

template <bool CMP>
__global__ void __launch_bounds__(kThreads, 2) sw_scores_kernel(Args a) {
  __shared__ int tab[(kMaxK + 1) * kMaxK];
  if (!CMP) {
    for (int i = threadIdx.x; i < a.K * a.K; i += kThreads) tab[i] = a.sub[i];
    for (int i = threadIdx.x; i < a.K; i += kThreads) tab[a.K * a.K + i] = -kLimit;
  }
  __syncthreads();
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int2* scr = a.scratch + warp * a.Lq;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(a.next, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= a.B) break;
    const int64_t pair = a.order[item];
    const int64_t qi = a.q_index[pair];
    const int64_t t0 = a.t_offsets[pair], t1 = a.t_offsets[pair + 1];
    if (qi < 0 || qi >= a.Q || t0 < 0 || t1 < t0 || t1 > a.T) {
      if (lane == 0) a.out[pair] = nanf("");
      continue;
    }
    const int qlen = min(max(a.q_lens[qi], 0), a.Lq);
    const int tlen = (int)(t1 - t0);
    const int8_t* qs = a.queries + qi * a.Lq;
    const int8_t* ts = a.targets + t0;
    // the streamed side: the longer one, but never a target longer than Lq
    const bool stream_q = qlen >= tlen || tlen > a.Lq;
    const int8_t* cols = stream_q ? ts : qs;
    const int8_t* rows = stream_q ? qs : ts;
    const int ncols = stream_q ? tlen : qlen;
    const int nrows = stream_q ? qlen : tlen;
    int best = 0;
    if (nrows > 0) {
      for (int col0 = 0; col0 < ncols;) {
        const int rem = ncols - col0;
        const bool first = col0 == 0;
        if (rem > 8 * kLanes) {
          best = max(best, sweep<kCols, CMP>(a, tab, cols, ncols, col0, rows, nrows, first,
                                             rem <= kCols * kLanes, scr, lane));
          col0 += kCols * kLanes;
        } else if (rem > 4 * kLanes) {
          best = max(best, sweep<8, CMP>(a, tab, cols, ncols, col0, rows, nrows, first, true,
                                         scr, lane));
          col0 = ncols;
        } else {
          best = max(best, sweep<4, CMP>(a, tab, cols, ncols, col0, rows, nrows, first, true,
                                         scr, lane));
          col0 = ncols;
        }
      }
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) a.out[pair] = (float)best;
  }
}

}  // namespace

// Blocks of the kernel resident on the current device at once (its SMs
// times the blocks an SM holds); 8 warps a block. 0 on an error.
extern "C" int mfx_sw_scores_blocks(void) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  int other = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sw_scores_kernel<true>, kThreads,
                                                    0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&other, sw_scores_kernel<false>, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return sms * min(per_sm, other);
}

// The best local score of pair b for every b < B: query q_index[b] (a row
// of queries [Q, Lq] int8, its length q_lens [Q] int32 clamped to [0, Lq])
// against targets[t_offsets[b] : t_offsets[b + 1]] (int8, T codes;
// q_index, t_offsets and order int64). sub [K, K] int32 (K <= 32,
// symmetric); compare != 0 scores match on the diagonal but for the last
// letter and mismatch elsewhere, which sub must say too. gap_open >=
// gap_extend >= 0; entries, gap costs and scores below 2^24 (the wrapper
// checks). order: the pairs in the order the warps take them. scratch:
// [blocks * 8, Lq] int2; next: one int32, 0; out [B] float32 (NaN for a
// pair whose query index or offsets are out of range). One launch of
// ``blocks`` blocks on ``stream``; returns its cudaError_t.
extern "C" int mfx_sw_scores(const void* queries, const void* q_lens, const void* q_index,
                             const void* targets, const void* t_offsets, const void* order,
                             const void* sub, int K, int Q, int B, int Lq, long long T,
                             int gap_open, int gap_extend, int compare, int match, int mismatch,
                             void* scratch, int blocks, void* next, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxK || Q < 1 || Lq < 0 || blocks < 1 || gap_extend < 0 ||
      gap_open < gap_extend || gap_open >= kLimit)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.queries = (const int8_t*)queries;
  a.q_lens = (const int32_t*)q_lens;
  a.q_index = (const int64_t*)q_index;
  a.targets = (const int8_t*)targets;
  a.t_offsets = (const int64_t*)t_offsets;
  a.order = (const int64_t*)order;
  a.sub = (const int32_t*)sub;
  a.K = K;
  a.Q = Q;
  a.B = B;
  a.Lq = Lq;
  a.T = T;
  a.go = gap_open;
  a.ge = gap_extend;
  a.match = match;
  a.mismatch = mismatch;
  a.scratch = (int2*)scratch;
  a.next = (int*)next;
  a.out = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (compare)
    sw_scores_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    sw_scores_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
