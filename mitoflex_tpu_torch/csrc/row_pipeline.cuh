// A pair's query columns as a systolic pipeline of warp stages, for Hopper
// (sm_90a): the skeleton that sw.cu (Smith-Waterman, S1) and genewise.cu
// (the frameshift DP, G1) instantiate with their recurrences.
//
// Both recurrences run over target positions t and query columns j, and
// every dependence of cell (t, j) comes from column j - 1 at the same or an
// earlier position, or from column j at earlier positions (F carries left
// to right within a position; the diagonal, the frameshifts and E read
// earlier positions). So a pair's columns run as stages over the target:
// - A stage is a warp. Lane l owns C consecutive columns and takes RW
//   consecutive positions a step (C = 1, 2, 4 and RW = 1, 2, template
//   arguments of the recurrence), so a stage spans a strip of 32 C
//   columns. At the stage's step st lane l works on block u = st - l
//   (positions RW u .. RW u + RW - 1), position by position, its columns
//   left to right, and hands what its last column passes on (the
//   recurrence's slot: at each position the F leaving it and that column's
//   state) to lane l + 1 by warp shuffles, which works on block u at the
//   next step. RW = 2 pays a step's fixed work and hand-offs once for two
//   positions and halves the chain's target term.
// - A pair's S stages are the P warps of a block times the CL blocks of a
//   thread-block cluster (CL <= 8); a block holds one pair. Strip i of a
//   query runs on stage i % S in round i / S. Lane 31 of a stage posts each
//   position's slot into the next stage's ring (handoff.cuh: tagged 64-bit
//   words, two to a 16-byte store, in the consumer's shared memory, acked,
//   kDepth slots deep), and the next stage's lanes all read it (a
//   broadcast) at their step t, lane 0 taking it; a waiting warp sleeps
//   between polls. Every lane runs the same instructions: the posts and
//   acks are predicated stores, and from step 31 to the last full block no
//   lane skips the cells. The last stage of a round writes the slots into
//   a [B, ceil(Lt / RW), slot] row in device memory, tagged with the round,
//   which stage 0 reads in the next round (32 blocks at a time, one a lane,
//   reloaded until tagged). A stage thus runs block u once its left
//   neighbour has: a pair's chain is about Lt / RW + 32 x strips steps, not
//   one pass of the target per strip, and no step has a block-wide
//   barrier.
// - Each lane loads its target code two steps ahead (neighbouring lanes on
//   neighbouring bytes, cached), and reads the next position's
//   substitution scores from a [K, K] table in shared memory (a stop column
//   after it where the recurrence scores stops) while a position runs.
//   Nothing on a cell's chain waits on device memory or a shuffle of codes.
// - Each lane keeps its best cell, replaced on a greater value or an equal
//   value in an earlier column (within a column the earliest position
//   wins); lanes reduce by shuffles, then the pair's warps and cluster
//   blocks, after the step loop, in the same launch.
// - A pair stops at its lengths: positions at or past t_len and columns at
//   or past q_len are not computed, and none inside them reads one.
//
// A recurrence R provides: C, N (32-bit path words a cell), kSlot (32-bit
// words a lane hands right), kStop (whether the table has a stop column), a
// Lane struct (a lane's registers across a strip) and reset, take (a slot
// into the lane where a predicate holds), put (the lane's slot), step (the
// lane's columns at one position) and write (the pair's answer).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "handoff.cuh"

namespace {

namespace rp {

namespace cg = cooperative_groups;

constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxThreads = 128;  // P warps a block
constexpr int kMaxSmem = 232448;  // 227 KB a block
constexpr int kCtlBytes = 64;     // a warp's ack word and its best cell
constexpr int kDepth = 8;         // slots of a hand-off ring (a deeper one ran no faster)

struct Args {
  const int8_t* queries;  // [B, Lq] codes
  const int32_t* q_lens;  // [B]
  const int8_t* targets;  // [B, Lt] codes
  const int32_t* t_lens;  // [B]
  const float* sub;       // [K, K]
  int K, B, Lq, Lt;
  int stop_code;          // the target code of the table's stop column
  float go, ge, fs, stop; // gap open and extend, frameshift and stop penalties
  uint64_t* scratch;      // [B, ceil(Lt / RW), kSlot] where strips wrap, else null
  int32_t* out;           // [kOut, B]
};

struct Layout {
  int P;   // stages (warps) of a pair in a block
  int CL;  // blocks a pair spans (cluster size)
};

// a score with its path words
template <int N>
struct Cell {
  float v;
  uint32_t w[N];
};

template <int N>
__device__ __forceinline__ Cell<N> cell(float v) {
  Cell<N> c;
  c.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.w[i] = 0;
  return c;
}

template <int N>
__device__ __forceinline__ Cell<N> sel(bool p, const Cell<N>& a, const Cell<N>& b) {
  Cell<N> c;
  c.v = p ? a.v : b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.w[i] = p ? a.w[i] : b.w[i];
  return c;
}

// a cell's words from w[o], and into it
template <int N, int S>
__device__ __forceinline__ Cell<N> unslot(const uint32_t (&w)[S], int o) {
  Cell<N> c;
  c.v = __uint_as_float(w[o]);
#pragma unroll
  for (int i = 0; i < N; ++i) c.w[i] = w[o + 1 + i];
  return c;
}

template <int N, int S>
__device__ __forceinline__ void enslot(uint32_t (&w)[S], int o, const Cell<N>& c) {
  w[o] = __float_as_uint(c.v);
#pragma unroll
  for (int i = 0; i < N; ++i) w[o + 1 + i] = c.w[i];
}

// a lane's best cell: value, column, position and path words
template <int N>
struct Best {
  float v;
  int j, t;
  uint32_t w[N];
};

// the lane's best takes h (column j, position t) where ``in`` and h is
// greater, or equal in an earlier column (selects, no branch)
template <int N>
__device__ __forceinline__ void offer(Best<N>& b, const Cell<N>& h, int j, int t, bool in) {
  const bool take = in && (h.v > b.v || (h.v == b.v && j < b.j));
  b.v = take ? h.v : b.v;
  b.j = take ? j : b.j;
  b.t = take ? t : b.t;
#pragma unroll
  for (int i = 0; i < N; ++i) b.w[i] = take ? h.w[i] : b.w[i];
}

struct Pen {
  float go, ge, fs;
};

__host__ __device__ inline int64_t table_bytes(int K, bool stop) {
  return ((int64_t)K * (K + (stop ? 1 : 0)) * 4 + 15) & ~(int64_t)15;
}

__host__ __device__ inline int64_t smem_bytes(int K, bool stop, int P, int slot) {
  return table_bytes(K, stop) + (int64_t)P * ((int64_t)kDepth * ((slot + 1) & ~1) * 8 + kCtlBytes);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// a ring slot's tagged words, loaded 16 bytes a load, and posted 16 bytes a
// store where p holds (the padding word of an odd slot carries the tag too)
template <int KP>
__device__ __forceinline__ void load_slot(uint64_t (&pre)[KP], uint32_t sa) {
#pragma unroll
  for (int k = 0; k < KP; k += 2) ld_word2(sa + 8 * k, pre[k], pre[k + 1]);
}

template <int K, int KP>
__device__ __forceinline__ void post_slot(bool p, bool remote, uint32_t sa, uint32_t tag,
                                          const uint32_t (&w)[K]) {
#pragma unroll
  for (int k = 0; k < KP; k += 2)
    st_word2_if(p, remote, sa + 8 * k, tag, w[k], k + 1 < K ? w[k + 1 < K ? k + 1 : 0] : 0u);
}

template <class R>
__global__ void __launch_bounds__(kMaxThreads) row_pipeline_kernel(Args a, Layout L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int C = R::C;
  constexpr int N = R::N;
  constexpr int RW = R::kRows;  // target positions a lane a step (a block)
  constexpr int kSlot = R::kSlot;
  constexpr int kSlotP = (kSlot + 1) & ~1;  // a ring slot's words, 16-byte aligned
  constexpr int Wd = kLanes * C;  // columns a strip
  const int lane = threadIdx.x & 31;
  const int pw = threadIdx.x >> 5;
  const int rank = (int)(blockIdx.x % (unsigned)L.CL);
  const int b = (int)(blockIdx.x / (unsigned)L.CL);  // the pair
  // the grid is B x CL blocks, so this holds; without the guard nvcc
  // schedules G1's step loop slower on an H100 (PERF.md §6)
  const bool pair_ok = b < a.B;
  const int S = L.P * L.CL;
  const int stage = rank * L.P + pw;
  const int K = a.K;
  const int TC = K + (R::kStop ? 1 : 0);

  // the substitution table (and the stop column, -stop, at code stop_code)
  float* tab = (float*)smem_raw;
  for (int i = threadIdx.x; i < K * TC; i += blockDim.x) {
    const int q = i / TC, x = i - q * TC;
    tab[i] = x < K ? a.sub[q * K + x] : -a.stop;
  }
  // this warp's inbound ring and control words ([0]: slots its consumer has
  // acked, [1..]: its best cell); the ring it posts into and the ack word of
  // its producer: a neighbouring warp's, or across the cluster the first
  // (last) warp of the pair in the next (previous) block
  const int ring_words = kDepth * kSlotP;
  const size_t wbytes = (size_t)ring_words * 8 + kCtlBytes;
  unsigned char* warps = smem_raw + table_bytes(K, R::kStop);
  unsigned char* mine = warps + (size_t)pw * wbytes;
  uint64_t* in_ring = (uint64_t*)mine;
  uint32_t* ctl = (uint32_t*)(mine + (size_t)ring_words * 8);
  for (int i = lane; i < ring_words; i += kLanes) in_ring[i] = 0;
  if (lane < kCtlBytes / 4) ctl[lane] = 0;
  const uint32_t in_a = (uint32_t)__cvta_generic_to_shared(in_ring);
  const uint32_t ack_a = (uint32_t)__cvta_generic_to_shared(ctl);
  const uint32_t wbase = (uint32_t)__cvta_generic_to_shared(warps);
  uint32_t out_a = pw + 1 < L.P ? in_a + (uint32_t)wbytes : wbase;
  uint32_t left_ack_a = pw > 0 ? ack_a - (uint32_t)wbytes
                               : wbase + (uint32_t)((L.P - 1) * wbytes + ring_words * 8);
  const bool out_remote = pw + 1 == L.P && rank + 1 < L.CL;
  const bool ack_remote = pw == 0 && rank > 0;
  if (out_remote) out_a = map_rank(out_a, rank + 1);
  if (ack_remote) left_ack_a = map_rank(left_ack_a, rank - 1);

  const int qlen = pair_ok ? clampi(a.q_lens[b], 0, a.Lq) : 0;
  const int tlen = pair_ok ? clampi(a.t_lens[b], 0, a.Lt) : 0;
  const int nstrips = (qlen + Wd - 1) / Wd;
  const int rounds = (nstrips + S - 1) / S;
  const int nblk = (tlen + RW - 1) / RW;  // blocks of RW positions
  const int nfull = tlen / RW;            // ... of which full
  uint64_t* scr = a.scratch ? a.scratch + (int64_t)b * ((a.Lt + RW - 1) / RW) * kSlot : nullptr;
  if (rounds > 1) {  // no slot of the row carries a round's tag yet
    const int64_t n = (int64_t)nblk * kSlot;
    for (int64_t i = (int64_t)stage * kLanes + lane; i < n; i += (int64_t)S * kLanes) scr[i] = 0;
  }
  // every ring and the scratch row are zeroed (no word carries a tag)
  // before any is posted into
  if (L.CL > 1) cg::this_cluster().sync(); else __syncthreads();

  const int8_t* qrow = a.queries + (int64_t)b * a.Lq;
  const int8_t* trow = a.targets + (int64_t)b * a.Lt;
  const Pen pen = {a.go, a.ge, a.fs};

  Best<N> best;
  best.v = 0.0f;
  best.j = best.t = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) best.w[i] = 0;
  // the links' running counts: slots read from the left (their ring index)
  // and posted to the right (theirs, and the last ack read)
  uint32_t seq_in = 0, seq_out = 0, acked = 0;
  int si_in = 0, si_out = 0;

  for (int rd = 0; rd < rounds; ++rd) {
    const int strip = rd * S + stage;
    if (strip >= nstrips) break;
    const int s0 = strip * Wd;
    const int j0 = s0 + lane * C;
    const int last_lane = (min(qlen - s0, Wd) - 1) / C;
    const bool more = strip + 1 < nstrips;
    const bool to_ring = more && stage + 1 < S;
    const bool to_scr = more && stage + 1 == S;
    const bool from_ring = stage > 0;
    const bool from_scr = stage == 0 && rd > 0;
    int qc[C], qoff[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      qc[c] = j < qlen ? clampi((int)qrow[j], 0, K - 1) : 0;
      qoff[c] = qc[c] * TC;
    }
    typename R::Lane ls;
    R::reset(ls);
    // the target's codes: lane l works on block u = st - l (positions
    // RW u .. RW u + RW - 1) at step st, and loads the codes of step st + 2
    // while step st runs (neighbouring lanes read neighbouring bytes,
    // cached); the scores of step st + 1 are read from the table while step
    // st runs
    auto code = [&](int tc) { return tc >= 0 && tc < tlen ? (int)__ldg(trow + tc) : 0; };
    int x[RW], x1[RW];
    float s[RW][C];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      x[r] = code(-lane * RW + r);
      x1[r] = code((1 - lane) * RW + r);
      const int xi = R::kStop && x[r] == a.stop_code ? K : clampi(x[r], 0, K - 1);
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = tab[qoff[c] + xi];
    }
    // the words of the next ring slot, loaded ahead (every lane: a broadcast)
    uint64_t pre[kSlotP];
#pragma unroll
    for (int k = 0; k < kSlotP; ++k) pre[k] = 0;
    if (from_ring && nblk > 0) load_slot<kSlotP>(pre, in_a + (uint32_t)(si_in * kSlotP * 8));
    // stage 0 after the first round: the scratch slots of blocks
    // [32 q, 32 q + 32), one a lane
    uint64_t cw[kSlot];
    bool cok = true;
    const uint32_t scr_tag = (uint32_t)rd;

    const int steps = nblk + last_lane;
    for (int st = 0; st < steps; ++st) {
      const int u = st - lane;
      const bool active = lane <= last_lane && u >= 0 && u < nblk;
      // lane 31 posts block up (every lane follows its counts); the
      // consumer's ack, read early: the post needs slot seq_out + 1 - kDepth
      const int up = st - (kLanes - 1);
      const bool posting = (to_ring || to_scr) && up >= 0 && up < nblk;
      uint32_t ack_early = acked;
      if (posting && to_ring && seq_out >= (uint32_t)kDepth &&
          acked < seq_out + 1 - (uint32_t)kDepth)
        ack_early = ld_ack(ack_a);
      int x2[RW];
      float sn[RW][C];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        x2[r] = code((st + 2 - lane) * RW + r);
        const int xi = R::kStop && x1[r] == a.stop_code ? K : clampi(x1[r], 0, K - 1);
#pragma unroll
        for (int c = 0; c < C; ++c) sn[r][c] = tab[qoff[c] + xi];
      }

      // ---- lane 0: the left's slot of block st
      if (from_scr && st < nblk) {
        const int o = st & 31;
        const int bp = st - o + lane;
        if (o == 0) {
          cok = true;
          if (bp < nblk) {
#pragma unroll
            for (int k = 0; k < kSlot; ++k) cw[k] = ld_global_word(scr + (int64_t)bp * kSlot + k);
#pragma unroll
            for (int k = 0; k < kSlot; ++k) cok = cok && has_tag(cw[k], scr_tag);
          }
        }
        while (!__shfl_sync(kAll, (int)cok, o)) {
          if (!cok) {
#pragma unroll
            for (int k = 0; k < kSlot; ++k) cw[k] = ld_global_word(scr + (int64_t)bp * kSlot + k);
            cok = true;
#pragma unroll
            for (int k = 0; k < kSlot; ++k) cok = cok && has_tag(cw[k], scr_tag);
          }
        }
        uint32_t w[kSlot];
#pragma unroll
        for (int k = 0; k < kSlot; ++k) w[k] = __shfl_sync(kAll, (uint32_t)cw[k], o);
        R::take(ls, w, lane == 0);
      }
      if (from_ring && st < nblk) {
        // every lane loads the slot (one broadcast read a word) until each
        // word carries its tag; lane 0 takes it and acks
        const uint32_t tag = seq_in + 1;
        for (;;) {
          bool ok = true;
#pragma unroll
          for (int k = 0; k < kSlotP; ++k) ok = ok && has_tag(pre[k], tag);
          if (__all_sync(kAll, ok)) break;
          __nanosleep(32);  // a waiting warp leaves the load pipe to the others
          load_slot<kSlotP>(pre, in_a + (uint32_t)(si_in * kSlotP * 8));
        }
        uint32_t w[kSlot];
#pragma unroll
        for (int k = 0; k < kSlot; ++k) w[k] = (uint32_t)pre[k];
        R::take(ls, w, lane == 0);
        st_ack_if(lane == 0, ack_remote, left_ack_a, tag);
        ++seq_in;
        si_in = si_in + 1 == kDepth ? 0 : si_in + 1;
        load_slot<kSlotP>(pre, in_a + (uint32_t)(si_in * kSlotP * 8));
      }

      // ---- this lane's columns over block u. From step 31 to nfull - 1
      // every lane's block lies inside the target: no lane waits on a
      // branch (lanes past the strip's end compute cells nothing reads,
      // and the best takes only cells inside the query and the target)
      if (st < kLanes - 1 || st >= nfull) {
        if (active) R::step(ls, best, u, j0, qlen, tlen, x, qc, s, pen);
      } else {
        R::step(ls, best, u, j0, qlen, tlen, x, qc, s, pen);
      }

      // ---- its slot: to the next stage (lane 31 of a full strip), and to
      // lane l + 1, which works on block u at the next step
      uint32_t w[kSlot];
      R::put(ls, w);
      if (posting) {
        if (to_ring) {
          if (seq_out >= (uint32_t)kDepth) {
            const uint32_t need = seq_out + 1 - (uint32_t)kDepth;
            acked = max(acked, ack_early);
            while (acked < need) {
              __nanosleep(32);  // a waiting warp leaves the load pipe to the others
              acked = ld_ack(ack_a);
            }
          }
          post_slot<kSlot, kSlotP>(lane == kLanes - 1, out_remote,
                                   out_a + (uint32_t)(si_out * kSlotP * 8), seq_out + 1, w);
          ++seq_out;
          si_out = si_out + 1 == kDepth ? 0 : si_out + 1;
        } else {
#pragma unroll
          for (int k = 0; k < kSlot; ++k)
            st_global_word_if(lane == kLanes - 1, scr + (int64_t)up * kSlot + k,
                              (uint32_t)rd + 1, w[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kSlot; ++k) w[k] = __shfl_up_sync(kAll, w[k], 1);
      R::take(ls, w, lane > 0);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        x[r] = x1[r];
        x1[r] = x2[r];
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = sn[r][c];
      }
    }
  }

  // ---- the answer: lanes, then the pair's warps and cluster blocks in
  // stage order; the first column of the maximum, at its earliest position
  for (int off = 16; off > 0; off >>= 1) {
    Best<N> o;
    o.v = __shfl_down_sync(kAll, best.v, off);
    o.j = __shfl_down_sync(kAll, best.j, off);
    o.t = __shfl_down_sync(kAll, best.t, off);
#pragma unroll
    for (int i = 0; i < N; ++i) o.w[i] = __shfl_down_sync(kAll, best.w[i], off);
    if (o.v > best.v || (o.v == best.v && o.j < best.j)) best = o;
  }
  if (lane == 0) {
    ctl[1] = __float_as_uint(best.v);
    ctl[2] = (uint32_t)best.j;
    ctl[3] = (uint32_t)best.t;
#pragma unroll
    for (int i = 0; i < N; ++i) ctl[4 + i] = best.w[i];
  }
  if (L.CL > 1) cg::this_cluster().sync(); else __syncthreads();
  if (pair_ok && rank == 0 && pw == 0 && lane == 0) {
    for (int q = 0; q < L.CL; ++q) {
      for (int s2 = 0; s2 < L.P; ++s2) {
        unsigned char* wp = warps + (size_t)s2 * wbytes;
        if (q > 0) wp = cg::this_cluster().map_shared_rank(wp, q);
        const uint32_t* o = (const uint32_t*)(wp + (size_t)ring_words * 8);
        Best<N> ob;
        ob.v = __uint_as_float(o[1]);
        ob.j = (int)o[2];
        ob.t = (int)o[3];
#pragma unroll
        for (int i = 0; i < N; ++i) ob.w[i] = o[4 + i];
        if (ob.v > best.v || (ob.v == best.v && ob.j < best.j)) best = ob;
      }
    }
    R::write(best, a.out, a.B, b);
  }
  // no block leaves while block 0 may still read its shared memory
  if (L.CL > 1) cg::this_cluster().sync();
}

// Launches recurrence R's pipeline; cudaErrorInvalidValue for a layout the
// kernel cannot run.
template <class R>
int launch(const Args& a, const Layout& L, cudaStream_t stream) {
  constexpr int Wd = kLanes * R::C;
  const int S = L.P * L.CL;
  if (L.P < 1 || L.CL < 1 || L.CL > kMaxCluster || kLanes * L.P > kMaxThreads || a.K < 1 ||
      a.Lq < 0 || a.Lt < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t strips = ((int64_t)a.Lq + Wd - 1) / Wd;
  const int64_t rounds = (strips + S - 1) / S;
  const int64_t blocks = ((int64_t)a.Lt + R::kRows - 1) / R::kRows;
  // a ring's and the scratch row's tags count slots in 32 bits
  if (rounds * (blocks + 1) >= 0xffffffffLL) return (int)cudaErrorInvalidValue;
  if (rounds > 1 && a.Lt > 0 && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(a.K, R::kStop, L.P, R::kSlot);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kern)(Args, Layout) = row_pipeline_kernel<R>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)((int64_t)a.B * L.CL));
  lc.blockDim = dim3((unsigned)(kLanes * L.P));
  lc.dynamicSmemBytes = (size_t)smem;
  lc.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)L.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = L.CL > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&lc, kern, a, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace rp

}  // namespace
