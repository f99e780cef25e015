// Profile-HMM local Viterbi scans for Hopper (sm_90a): nhmmer's two passes.
//
// Replaces the XLA lax.scans of mitoflex_tpu/ops/phmm.py: viterbi_scores_multi
// (:352, the pass-1 sweep of every stacked model over every window, scores
// only; viterbi_scores :277 is its one-model case) and viterbi_scan (:140,
// pass 2: the best score with its envelope). In the port their plain
// versions are mitoflex_tpu_torch/ops/phmm.py viterbi_scores_multi_plain and
// viterbi_scan_plain, a Python loop of tensor steps, 35 to 70 eager launches
// a position. Here one launch runs every position of every row.
//
// The recurrence, per window position t and model column j (NEG = -1e30):
//   M[t,j] = em + best(entry, M[t-1,j-1] + tMM, I[t-1,j-1] + tIM,
//                      D[t-1,j-1] + tDM)        (a later one only if greater)
//   I[t,j] = ei + max(M[t-1,j] + tMI, I[t-1,j] + tII)              (M on ties)
//   D[t,j] = cm[j-1] + cdd[j-1],  cm = closure of a = (M[t,j] + tMD) - cdd
// The closure is the plain version's: banded, W = 2^r columns for r doubling
// rounds (the rightmost maximum of a[j-W+1 .. j], columns left of 0 entering
// as (NEG, payload 0)); or exact (scan pass with delete_band <= 0), the
// leftmost maximum of a[0 .. j]. Every float operation is the plain
// version's, in its order (adds, compares and maxima only: nothing to
// contract into an FMA), so the scores are bit-equal and every coordinate
// exact. Max is exact, so any association of the closure's maxima gives the
// same value, and the tie rules (rightmost / leftmost) fix the payloads.
//
// What bounds it on the H100: float32 ALU work, M * B * T * L cells at
// 15 + log2(W) operations a cell (scores pass; the scan pass about 30 +
// 4 log2(W) with the envelope payloads) over 67 TFLOP/s outside the tensor
// cores; the profiles and windows are a few MB, so device memory is no
// limit. But a row is a serial chain of T steps, and nhmmer's pass 2 sends
// few rows a call (3 at Lp 2048 in the golden run's largest), so what
// decides the time is how short one step of one row can be made.
//
// Design: a row's columns run as a systolic pipeline of stages.
// - A stage is a warp; lane l owns K consecutive columns (K = 1, 2, 4, 8),
//   with their transitions, emission rows (K <= 2 scan, K <= 4 scores), M,
//   I, D, payloads and per-column bests in registers, so a stage spans
//   S = 32 K columns. A payload (the step and column an alignment starts at)
//   is one packed word, ts << 16 | js. A row's stages are the P warps of a
//   block times the C blocks of a thread-block cluster (C <= 8); a block
//   holds R rows. ops/phmm.py viterbi_config picks (K, P, R, C) from the
//   shape and the SM count: few rows one lane a column over a cluster of
//   SMs (a step's latency is the call's time), many rows 4 columns a lane
//   and one warp (Lp 128) or one block a row (the card's issue rate is).
//   Each K has two instantiations: the default band's window (16) fixed at
//   compile time, and any window read at run time.
// - Every dependence of column j at step t comes from its left or from step
//   t-1, so stage s runs step t as soon as stage s-1 has posted step t's
//   slot: its last column's M, I, D (+ payloads) after step t (read at step
//   t+1), its last W columns' suffix maxima of a (banded closure; the suffix
//   of length W - o is what column o of stage s needs from its left), or its
//   running prefix (exact closure). The hand-off latency is paid once, to
//   fill the pipeline; no step has a block-wide barrier.
// - Inside a stage: neighbouring columns through __shfl_up_sync; the banded
//   closure as log2(W) doubling rounds of shuffles over the stage (rightmost
//   on ties) plus, for the right neighbour, log2(W) rounds of a suffix scan
//   (shfl_down); the exact closure as a lane-serial prefix and a 5-round
//   warp scan (leftmost on ties). Payloads ride along with their values.
// - Hand-offs go through a ring of kDepth slots in the consumer's shared
//   memory (a neighbouring warp's, or the next cluster block's through
//   distributed shared memory, addressed by mapa; csrc/handoff.cuh). Each posted word is 64
//   bits, its step in the high half, so it validates itself (a relaxed
//   64-bit store is single-copy atomic): the consumer issues all its loads
//   at once (lane 0 the head, each lane its suffix entries) and again until
//   every word carries the step, and no fence or flag is needed. The
//   consumer's ack (steps consumed), in the producer's shared memory, keeps
//   the producer kDepth steps ahead at most.
// - The next step's code (from a warp-wide chunk of 32 codes, shuffled) and
//   emission scores are fetched while a step runs. Rows stop at their
//   length: past it every emission is NEG, so no best and no payload could
//   change. Columns at or past the model length never feed a column inside
//   it, so they and whole stages past it are skipped.
// - The final pick (the first column of the per-column best maximum with its
//   payloads; the row maximum in the scores pass) reduces lanes by shuffles,
//   then the row's warps and cluster blocks, after the step loop, in the
//   same launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "handoff.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB a block
constexpr int kCtlBytes = 32;     // a warp's ack word and final pick
constexpr int kDepth = 4;         // slots of a hand-off ring
constexpr int kMaxT = 65536;      // steps a row (a payload packs a step in 16 bits)

// threads a block may have at K columns a lane (each instantiation's bound)
__host__ __device__ constexpr int max_threads(int K) { return K == 1 ? 512 : 256; }
// blocks an SM must hold: the scores pass at K 4 (one warp a Lp-128 row, or
// a Lp-1024/2048 row a block when rows are many) keeps two blocks of 256
// threads resident, at most 128 registers a thread
__host__ __device__ constexpr int min_blocks(int K, bool scan) { return !scan && K == 4 ? 2 : 1; }

// 64-bit words of a hand-off slot: scan: M I D, their payloads (ts, js
// packed in a word each), the exact closure's carry (value, payload), then
// the W suffix values and their W payloads; scores: M I D and the W suffix
// values
__host__ __device__ inline int slot_words(int W, bool scan) {
  return scan ? 8 + 2 * W : 3 + W;
}

__host__ __device__ inline int64_t smem_bytes(int P, int R, int W, bool scan) {
  return (int64_t)P * R * ((int64_t)kDepth * slot_words(W, scan) * 8 + kCtlBytes);
}

struct Args {
  const float* msc;  // [Mn, Lp, 4]
  const float* isc;
  const float* tmm;  // [Mn, Lp] each
  const float* tim;
  const float* tdm;
  const float* tmi;
  const float* tii;
  const float* tmd;
  const float* cdd;
  const float* entry;         // [Mn]
  const int32_t* model_lens;  // [Mn] (scores pass) or null
  int model_len;              // scan pass
  const int8_t* seqs;         // [B, T]
  const int32_t* lengths;     // [B]
  int B, T, Lp, rows;         // rows = Mn * B
  float* out_score;  // scores pass: [Mn, B]; scan pass: [B]
  int32_t* out_from;
  int32_t* out_to;
  int32_t* out_hmm_from;
  int32_t* out_hmm_to;
};

struct Cfg {
  int P;      // stages (warps) of a row in a block
  int R;      // rows a block
  int C;      // blocks a row spans (cluster size)
  int W;      // closure window; 0: exact (scan pass)
  int slot;   // 64-bit words a slot
};

__device__ __forceinline__ uint32_t fbits(float x) { return __float_as_uint(x); }
// a payload (ts: the step an alignment starts at, < 65536; js: its first
// column + 1, <= 8192) in one word, as registers and slots carry it
__device__ __forceinline__ uint32_t pack(int ts, int js) {
  return ((uint32_t)ts << 16) | (uint32_t)js;
}
__device__ __forceinline__ float bitsf(uint32_t x) { return __uint_as_float(x); }

// v[c] for a code c in 0..3, by selects
__device__ __forceinline__ float pick4(const float (&v)[4], int c) {
  return (c & 2) ? ((c & 1) ? v[3] : v[2]) : ((c & 1) ? v[1] : v[0]);
}

// WT: the closure window at compile time (16, the default band's), or 0:
// the window c.W read at run time (any band, the exact closure included)
template <int K, bool SCAN, int WT>
__global__ void __launch_bounds__(max_threads(K), min_blocks(K, SCAN))
viterbi_kernel(Args p, Cfg c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int S = kLanes * K;  // columns a stage
  constexpr int kSuffix = SCAN ? 8 : 3;
  // emission rows in registers (4 codes a column, selected a step), or
  // read from the profile a step where registers are short
  constexpr bool kRegEm = SCAN ? K <= 2 : K <= 4;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int r = wib / c.P;
  const int pw = wib - r * c.P;
  const int rank = (int)(blockIdx.x % (unsigned)c.C);
  const int row = (int)(blockIdx.x / (unsigned)c.C) * c.R + r;
  const bool row_ok = row < p.rows;
  const int stage = rank * c.P + pw;
  const int j0 = stage * S + lane * K;
  const int W = WT > 0 ? WT : c.W;
  const bool exact = SCAN && W <= 0;

  const int m = row_ok ? row / p.B : 0;
  const int b = row_ok ? row - m * p.B : 0;
  const int ml = SCAN ? p.model_len : (row_ok ? p.model_lens[m] : 0);
  const int n = max(0, min(ml, p.Lp));  // columns inside the model
  const int t_end = row_ok ? max(0, min(p.lengths[b], p.T)) : 0;
  const bool active = row_ok && stage * S < n;
  const bool has_left = stage > 0;
  const bool has_right = active && (stage + 1) * S < n;

  // this warp's inbound ring and control words ([0]: steps its consumer has
  // acked, [1..5): the final pick); the ring it posts into and the ack word
  // of its producer: a neighbouring warp's, or across the cluster the first
  // (last) warp of the row in the next (previous) block
  const int ring_words = kDepth * c.slot;
  const size_t wbytes = (size_t)ring_words * 8 + kCtlBytes;
  unsigned char* mine = smem_raw + (size_t)wib * wbytes;
  uint64_t* in_ring = (uint64_t*)mine;
  uint32_t* ctl = (uint32_t*)(mine + (size_t)ring_words * 8);
  for (int i = lane; i < ring_words; i += kLanes) in_ring[i] = 0;
  if (lane < kCtlBytes / 4) ctl[lane] = 0;
  const uint32_t in_a = (uint32_t)__cvta_generic_to_shared(in_ring);
  const uint32_t ack_a = (uint32_t)__cvta_generic_to_shared(ctl);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint32_t out_a = pw + 1 < c.P ? in_a + (uint32_t)wbytes : base + (uint32_t)(r * c.P * wbytes);
  uint32_t left_ack_a = pw > 0 ? ack_a - (uint32_t)wbytes
                               : base + (uint32_t)((r * c.P + c.P - 1) * wbytes + ring_words * 8);
  const bool out_remote = pw + 1 == c.P && rank + 1 < c.C;
  const bool ack_remote = pw == 0 && rank > 0;
  if (out_remote) out_a = map_rank(out_a, rank + 1);
  if (ack_remote) left_ack_a = map_rank(left_ack_a, rank - 1);
  // every ring is zeroed (no word carries a step) before any is posted into
  if (c.C > 1) cg::this_cluster().sync(); else __syncthreads();

  const int64_t moff = (int64_t)m * p.Lp;
  const float* msc = p.msc + moff * 4;
  const float* isc = p.isc + moff * 4;
  const float entry = row_ok ? p.entry[m] : 0.0f;

  float tmm[K], tim[K], tdm[K], tmi[K], tii[K], tmd[K], cdd[K];
  float M[K], I[K], D[K];
  int Mp[K], Ip[K], Dp[K];  // their payloads, packed: ts << 16 | js
  float bV[K];
  int bVp[K], bVt[K];
  float mE[kRegEm ? K : 1][4], iE[kRegEm ? K : 1][4];
  float best = kNeg;   // scores pass: the row's best M so far
  const float cdd_left = (active && j0 > 0 && j0 < n) ? p.cdd[moff + j0 - 1] : 0.0f;
  // columns at or past the model length keep NEG parameters: they compute
  // without branches, and nothing they hold reaches a column inside it
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    const bool in = active && j < n;
    tmm[k] = in ? p.tmm[moff + j] : kNeg;
    tim[k] = in ? p.tim[moff + j] : kNeg;
    tdm[k] = in ? p.tdm[moff + j] : kNeg;
    tmi[k] = in ? p.tmi[moff + j] : kNeg;
    tii[k] = in ? p.tii[moff + j] : kNeg;
    tmd[k] = in ? p.tmd[moff + j] : kNeg;
    cdd[k] = in ? p.cdd[moff + j] : kNeg;
    M[k] = I[k] = D[k] = kNeg;
    Mp[k] = Ip[k] = Dp[k] = 0;
    bV[k] = kNeg;
    bVp[k] = bVt[k] = 0;
    if constexpr (kRegEm) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mE[k][q] = in ? msc[j * 4 + q] : kNeg;
        iE[k][q] = in ? isc[j * 4 + q] : kNeg;
      }
    }
  }
  // the left neighbour's last column after the previous step (stage 0: the
  // plain version's fill, NEG with payload 0)
  float lbM = kNeg, lbI = kNeg, lbD = kNeg;
  int lbP[3] = {0, 0, 0};

  const int8_t* seq = p.seqs + (int64_t)b * p.T;
  // the codes of steps [32 q, 32 q + 32), one a lane, and of the next 32
  int chunk = 4, chunk_next = 4;
  if (active) {
    chunk = lane < t_end ? (int)seq[lane] : 4;
    chunk_next = 32 + lane < t_end ? (int)seq[32 + lane] : 4;
  }
  uint32_t acked = 0;  // the consumer's ack last read (producer side)
  int si = 0;          // this step's slot of the rings

  for (int t = 0; active && t < t_end; ++t) {
    const uint32_t tag = (uint32_t)t + 1;
    // the consumer's ack, read early: the post below needs step t + 1 - kDepth
    uint32_t ack_early = acked;
    if (has_right && lane == 0 && t >= kDepth && acked < tag - (uint32_t)kDepth)
      ack_early = ld_ack(ack_a);
    // ---- this step's code and emissions
    if ((t & 31) == 0 && t > 0) {
      chunk = chunk_next;
      const int tn = t + 32 + lane;
      chunk_next = tn < t_end ? (int)seq[tn] : 4;
    }
    const int x = __shfl_sync(kAll, chunk, t & 31);
    const bool xv = x < 4;
    const int cx = x < 0 ? 0 : (x & 3);
    float em[K], ei[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (kRegEm) {
        em[k] = xv ? pick4(mE[k], cx) : kNeg;
        ei[k] = xv ? pick4(iE[k], cx) : kNeg;
      } else {
        const int j = j0 + k;
        em[k] = (xv && j < n) ? __ldg(msc + j * 4 + cx) : kNeg;
        ei[k] = (xv && j < n) ? __ldg(isc + j * 4 + cx) : kNeg;
      }
    }

    // ---- M and I from the previous step's state; a = (M + tMD) - cdd
    float nM = __shfl_up_sync(kAll, M[K - 1], 1);
    float nI = __shfl_up_sync(kAll, I[K - 1], 1);
    float nD = __shfl_up_sync(kAll, D[K - 1], 1);
    int nP[3];
    if constexpr (SCAN) {
      nP[0] = __shfl_up_sync(kAll, Mp[K - 1], 1);
      nP[1] = __shfl_up_sync(kAll, Ip[K - 1], 1);
      nP[2] = __shfl_up_sync(kAll, Dp[K - 1], 1);
    }
    if (lane == 0) {
      nM = lbM;
      nI = lbI;
      nD = lbD;
      if constexpr (SCAN) {
#pragma unroll
        for (int q = 0; q < 3; ++q) nP[q] = lbP[q];
      }
    }
    float av[K];
    int ap[K];
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int j = j0 + k;
      const float pM = k ? M[k - 1] : nM;
      const float pI = k ? I[k - 1] : nI;
      const float pD = k ? D[k - 1] : nD;
      float bst;
      int pl = 0;
      if constexpr (SCAN) {
        bst = entry;
        pl = (int)pack(t, j + 1);
        float v = pM + tmm[k];
        if (v > bst) { bst = v; pl = k ? Mp[k - 1] : nP[0]; }
        v = pI + tim[k];
        if (v > bst) { bst = v; pl = k ? Ip[k - 1] : nP[1]; }
        v = pD + tdm[k];
        if (v > bst) { bst = v; pl = k ? Dp[k - 1] : nP[2]; }
        const float ivm = M[k] + tmi[k];
        const float ivi = I[k] + tii[k];
        const bool take_m = ivm >= ivi;
        Ip[k] = take_m ? Mp[k] : Ip[k];
        I[k] = ei[k] + (take_m ? ivm : ivi);
      } else {
        bst = fmaxf(fmaxf(entry, pM + tmm[k]), fmaxf(pI + tim[k], pD + tdm[k]));
        I[k] = ei[k] + fmaxf(M[k] + tmi[k], I[k] + tii[k]);
      }
      M[k] = em[k] + bst;
      Mp[k] = pl;
      av[k] = (M[k] + tmd[k]) - cdd[k];
      ap[k] = pl;
    }

    // ---- this stage's part of the closure, before the left's slot is read
    // fv: banded, the rightmost maximum of a over [max(stage start, j-W+1), j]
    // (identity -inf left of the stage); exact, the lane's own inclusive
    // leftmost prefix. bv: the suffix maxima the right neighbour reads
    // (computed by every stage: without a branch its rounds overlap fv's).
    float fv[K], bv[K];
    int fp[K], bp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      fv[k] = bv[k] = av[k];
      fp[k] = bp[k] = ap[k];
    }
    if (exact) {
#pragma unroll
      for (int k = 1; k < K; ++k) {
        if (!(av[k] > fv[k - 1])) {  // the left one on ties
          fv[k] = fv[k - 1]; fp[k] = fp[k - 1];
        }
      }
    } else {
#pragma unroll
      for (int r2 = 0; (1 << r2) < K; ++r2) {
        const int d = 1 << r2;
        if (d < W) {
          float uv[K], dv[K];
          int up[K], dp[K];
#pragma unroll
          for (int k = 0; k < d; ++k) {
            uv[k] = __shfl_up_sync(kAll, fv[K - d + k], 1);
            if (lane == 0) uv[k] = -INFINITY;
            if constexpr (SCAN) up[k] = __shfl_up_sync(kAll, fp[K - d + k], 1);
          }
#pragma unroll
          for (int k = K - d; k < K; ++k) {
            dv[k] = __shfl_down_sync(kAll, bv[k + d - K], 1);
            if (lane == kLanes - 1) dv[k] = -INFINITY;
            if constexpr (SCAN) dp[k] = __shfl_down_sync(kAll, bp[k + d - K], 1);
          }
#pragma unroll
          for (int k = K - 1; k >= 0; --k) {  // reads fv[k - d] before it changes
            const float lv = k >= d ? fv[k >= d ? k - d : 0] : uv[k];
            if constexpr (SCAN) {
              const int lp = k >= d ? fp[k >= d ? k - d : 0] : up[k];
              if (!(fv[k] >= lv)) { fv[k] = lv; fp[k] = lp; }
            } else {
              fv[k] = fmaxf(fv[k], lv);
            }
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {  // reads bv[k + d] before it changes
            const float rv = k + d < K ? bv[k + d < K ? k + d : 0] : dv[k];
            if constexpr (SCAN) {
              const int rp = k + d < K ? bp[k + d < K ? k + d : 0] : dp[k];
              if (rv >= bv[k]) { bv[k] = rv; bp[k] = rp; }
            } else {
              bv[k] = fmaxf(bv[k], rv);
            }
          }
        }
      }
#pragma unroll
      for (int d = K; d < W; d <<= 1) {
        const int L = d / K;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float lv = __shfl_up_sync(kAll, fv[k], L);
          if constexpr (SCAN) {
            const int lp = __shfl_up_sync(kAll, fp[k], L);
            if (lane >= L && !(fv[k] >= lv)) { fv[k] = lv; fp[k] = lp; }
          } else {
            if (lane >= L) fv[k] = fmaxf(fv[k], lv);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float rv = __shfl_down_sync(kAll, bv[k], L);
          if constexpr (SCAN) {
            const int rp = __shfl_down_sync(kAll, bp[k], L);
            if (lane + L < kLanes && rv >= bv[k]) { bv[k] = rv; bp[k] = rp; }
          } else {
            if (lane + L < kLanes) bv[k] = fmaxf(bv[k], rv);
          }
        }
      }
    }

    // ---- the left's slot of this step: its last column's state (for the
    // next step), its suffix maxima (banded) or running prefix (exact)
    float ev[K];
    int ep[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ev[k] = kNeg;  // stage 0: the fill columns left of column 0
      ep[k] = 0;
    }
    float cv = -INFINITY;  // exact: the prefix left of the stage (none)
    int cp = 0;
    if (has_left) {
      // lane 0 reads the head (M I D, payloads, carry), every lane its
      // suffix entries: all loads issued together, again until each word
      // carries step t
      const uint32_t slot = in_a + (uint32_t)(si * c.slot * 8);
      constexpr int kHead = SCAN ? 8 : 3;
      const int head = SCAN ? (exact ? 8 : 6) : 3;
      uint64_t hw[kHead];
      uint64_t s0[K], s1[K];
      bool ok;
      do {
        ok = true;
#pragma unroll
        for (int q = 0; q < kHead; ++q) {
          hw[q] = (uint64_t)tag << 32;
          if (lane == 0 && q < head) hw[q] = ld_word(slot + 8 * q);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int o = lane * K + k;
          s0[k] = s1[k] = (uint64_t)tag << 32;
          if (!exact && o < W) {
            s0[k] = ld_word(slot + 8 * (kSuffix + o));
            if constexpr (SCAN) s1[k] = ld_word(slot + 8 * (kSuffix + W + o));
          }
        }
#pragma unroll
        for (int q = 0; q < kHead; ++q) ok = ok && has_tag(hw[q], tag);
#pragma unroll
        for (int k = 0; k < K; ++k) ok = ok && has_tag(s0[k], tag) && has_tag(s1[k], tag);
      } while (!ok);
      if (lane == 0) {
        lbM = bitsf((uint32_t)hw[0]);
        lbI = bitsf((uint32_t)hw[1]);
        lbD = bitsf((uint32_t)hw[2]);
        if constexpr (SCAN) {
#pragma unroll
          for (int q = 0; q < 3; ++q) lbP[q] = (int)(uint32_t)hw[3 + q];
        }
      }
      if constexpr (SCAN) {
        if (exact) {
          cv = bitsf(__shfl_sync(kAll, (uint32_t)hw[6], 0));
          cp = (int)__shfl_sync(kAll, (uint32_t)hw[7], 0);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!exact && lane * K + k < W) {
          ev[k] = bitsf((uint32_t)s0[k]);
          ep[k] = (int)(uint32_t)s1[k];
        }
      }
      __syncwarp();
      if (lane == 0) st_ack(ack_remote, left_ack_a, tag);
    }

    // ---- D from cm[j-1]; the per-column best
    float cov = 0.0f;  // exact: the prefix through this stage (lane 31)
    int cop = 0;
    if (exact) {
      if constexpr (SCAN) {
        // the lanes' totals, scanned (the left one on ties), then the carry
        float xv2 = fv[K - 1];
        int xp = fp[K - 1];
#pragma unroll
        for (int d = 1; d < kLanes; d <<= 1) {
          const float yv = __shfl_up_sync(kAll, xv2, d);
          const int yp = __shfl_up_sync(kAll, xp, d);
          if (lane >= d && yv >= xv2) { xv2 = yv; xp = yp; }
        }
        float pv = __shfl_up_sync(kAll, xv2, 1);
        int pp = __shfl_up_sync(kAll, xp, 1);
        if (lane == 0 || cv >= pv) { pv = cv; pp = cp; }
        // pv: the leftmost maximum of a over every column left of this lane
#pragma unroll
        for (int k = 0; k < K; ++k) {
          D[k] = (pv == -INFINITY ? kNeg : pv) + (k ? cdd[k - 1] : cdd_left);
          Dp[k] = pp;
          if (!(fv[k] > pv)) { fv[k] = pv; fp[k] = pp; }
          pv = fv[k];
          pp = fp[k];
        }
        cov = pv;
        cop = pp;
      }
    } else {
      float sv = __shfl_up_sync(kAll, fv[K - 1], 1);
      int sp = 0;
      if constexpr (SCAN) sp = __shfl_up_sync(kAll, fp[K - 1], 1);
      if (lane == 0) sv = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float pv = k ? fv[k - 1] : sv;
        int pp = k ? fp[k - 1] : sp;
        if (lane * K + k < W) {  // the window reaches into the left stage
          if constexpr (SCAN) {
            if (!(pv >= ev[k])) { pv = ev[k]; pp = ep[k]; }
          } else {
            pv = fmaxf(pv, ev[k]);
          }
        }
        D[k] = pv + (k ? cdd[k - 1] : cdd_left);
        if constexpr (SCAN) Dp[k] = pp;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = j0 + k < n;
      if constexpr (SCAN) {
        if (in && M[k] > bV[k]) {
          bV[k] = M[k];
          bVp[k] = Mp[k];
          bVt[k] = t;
        }
      } else {
        best = fmaxf(best, in ? M[k] : kNeg);
      }
    }

    // ---- post this step's slot to the right neighbour
    if (has_right) {
      if (lane == 0 && t >= kDepth) {
        const uint32_t need = tag - (uint32_t)kDepth;
        acked = max(acked, ack_early);
        while (acked < need) acked = ld_ack(ack_a);
      }
      __syncwarp();
      const uint32_t slot = out_a + (uint32_t)(si * c.slot * 8);
      if (lane == kLanes - 1) {
        st_word(out_remote, slot + 0, tag, fbits(M[K - 1]));
        st_word(out_remote, slot + 8, tag, fbits(I[K - 1]));
        st_word(out_remote, slot + 16, tag, fbits(D[K - 1]));
        if constexpr (SCAN) {
          st_word(out_remote, slot + 24, tag, (uint32_t)Mp[K - 1]);
          st_word(out_remote, slot + 32, tag, (uint32_t)Ip[K - 1]);
          st_word(out_remote, slot + 40, tag, (uint32_t)Dp[K - 1]);
          if (exact) {
            st_word(out_remote, slot + 48, tag, fbits(cov));
            st_word(out_remote, slot + 56, tag, (uint32_t)cop);
          }
        }
      }
      if (!exact) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int o = lane * K + k - (S - W);  // suffix of length W - o
          if (o >= 0) {
            st_word(out_remote, slot + 8 * (kSuffix + o), tag, fbits(bv[k]));
            if constexpr (SCAN) st_word(out_remote, slot + 8 * (kSuffix + W + o), tag, (uint32_t)bp[k]);
          }
        }
      }
    }
    si = si + 1 == kDepth ? 0 : si + 1;
  }

  // ---- the final pick: lanes, then the row's warps and cluster blocks in
  // stage order; the first column of the maximum (scores: the maximum).
  // Every lane starts from column 0 at NEG with zero payloads, which is
  // column 0's own state whenever its best is still NEG.
  float v = kNeg;
  int col = 0, vp = 0, vt = 0;
  if constexpr (SCAN) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < n && bV[k] > v) {
        v = bV[k]; col = j0 + k; vp = bVp[k]; vt = bVt[k];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kAll, v, off);
      const int oc = __shfl_down_sync(kAll, col, off);
      const int op = __shfl_down_sync(kAll, vp, off);
      const int ot = __shfl_down_sync(kAll, vt, off);
      if (ov > v || (ov == v && oc < col)) {
        v = ov; col = oc; vp = op; vt = ot;
      }
    }
  } else {
    v = best;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(kAll, v, off));
  }
  if (lane == 0) {
    ctl[1] = fbits(v);
    ctl[2] = (uint32_t)col;
    ctl[3] = (uint32_t)vp;
    ctl[4] = (uint32_t)vt;
  }
  if (c.C > 1) cg::this_cluster().sync(); else __syncthreads();
  if (row_ok && rank == 0 && pw == 0 && lane == 0) {
    for (int q = 0; q < c.C; ++q) {
      for (int s2 = 0; s2 < c.P; ++s2) {
        unsigned char* w = smem_raw + (size_t)(r * c.P + s2) * wbytes;
        if (q > 0) w = cg::this_cluster().map_shared_rank(w, q);
        const uint32_t* o = (const uint32_t*)(w + (size_t)ring_words * 8);
        const float ov = bitsf(o[1]);
        if constexpr (SCAN) {
          const int oc = (int)o[2];
          if (ov > v || (ov == v && oc < col)) {
            v = ov; col = oc; vp = (int)o[3]; vt = (int)o[4];
          }
        } else {
          v = fmaxf(v, ov);
        }
      }
    }
    if constexpr (SCAN) {
      p.out_score[b] = v;
      p.out_from[b] = (int)((uint32_t)vp >> 16);
      p.out_to[b] = vt;
      p.out_hmm_from[b] = (int)((uint32_t)vp & 0xffffu);
      p.out_hmm_to[b] = col + 1;
    } else {
      p.out_score[row] = v;
    }
  }
  // no block leaves while block 0 may still read its shared memory
  if (c.C > 1) cg::this_cluster().sync();
}

template <bool SCAN>
int launch(const Args& a, int K, int P, int R, int C, int W, cudaStream_t stream) {
  const bool ok_k = K == 1 || K == 2 || K == 4 || K == 8;
  if (!ok_k || P < 1 || R < 1 || C < 1 || C > kMaxCluster || a.Lp <= 0 ||
      a.rows <= 0 || 32 * P * R > max_threads(K) || (int64_t)kLanes * K * P * C < a.Lp ||
      W < (SCAN ? 0 : 1) || W > kLanes * K || smem_bytes(P, R, W, SCAN) > kMaxSmem ||
      a.T >= kMaxT)
    return (int)cudaErrorInvalidValue;
  void (*kern)(Args, Cfg) = nullptr;
  const bool w16 = W == 16;
  switch (K) {
    case 1: kern = w16 ? viterbi_kernel<1, SCAN, 16> : viterbi_kernel<1, SCAN, 0>; break;
    case 2: kern = w16 ? viterbi_kernel<2, SCAN, 16> : viterbi_kernel<2, SCAN, 0>; break;
    case 4: kern = w16 ? viterbi_kernel<4, SCAN, 16> : viterbi_kernel<4, SCAN, 0>; break;
    default: kern = w16 ? viterbi_kernel<8, SCAN, 16> : viterbi_kernel<8, SCAN, 0>; break;
  }
  const int smem = (int)smem_bytes(P, R, W, SCAN);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Cfg cfg = {P, R, C, W, slot_words(W, SCAN)};
  const int64_t groups = ((int64_t)a.rows + R - 1) / R;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((unsigned)(groups * C));
  lc.blockDim = dim3((unsigned)(32 * P * R));
  lc.dynamicSmemBytes = (size_t)smem;
  lc.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&lc, kern, a, cfg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Args profile_args(const void* msc, const void* isc, const void* tmm, const void* tim,
                  const void* tdm, const void* tmi, const void* tii, const void* tmd,
                  const void* cdd, const void* entry, const void* seqs,
                  const void* lengths, int B, int T, int Lp) {
  Args a = {};
  a.msc = (const float*)msc; a.isc = (const float*)isc;
  a.tmm = (const float*)tmm; a.tim = (const float*)tim; a.tdm = (const float*)tdm;
  a.tmi = (const float*)tmi; a.tii = (const float*)tii; a.tmd = (const float*)tmd;
  a.cdd = (const float*)cdd; a.entry = (const float*)entry;
  a.seqs = (const int8_t*)seqs; a.lengths = (const int32_t*)lengths;
  a.B = B; a.T = T; a.Lp = Lp;
  return a;
}

}  // namespace

// Shared memory bytes a block of the configuration takes (ops/phmm.py's
// viterbi_config mirrors this; chip_smoke.py holds the two equal).
extern "C" long long mfx_viterbi_smem_bytes(int P, int R, int window, int scan) {
  return (long long)smem_bytes(P, R, window, scan != 0);
}

// Pass 1: out[Mn, B] best scores of every stacked model on every window.
// Profile arrays are [Mn, Lp, 4] (msc, isc) and [Mn, Lp] (transitions,
// cdd), entry and model_lens [Mn]; seqs [B, T] int8, lengths [B] int32.
// window: the closure's width, the least power of two >= max(band, 2).
// K, P, R, C: the layout (ops/phmm.py viterbi_config).
extern "C" int mfx_viterbi_scores(
    const void* msc, const void* isc, const void* tmm, const void* tim,
    const void* tdm, const void* tmi, const void* tii, const void* tmd,
    const void* cdd, const void* entry, const void* model_lens, int Mn,
    const void* seqs, const void* lengths, int B, int T, int Lp, int window,
    int K, int P, int R, int C, void* out, void* stream) {
  if (Mn <= 0 || B <= 0) return (int)cudaSuccess;
  Args a = profile_args(msc, isc, tmm, tim, tdm, tmi, tii, tmd, cdd, entry, seqs,
                        lengths, B, T, Lp);
  a.model_lens = (const int32_t*)model_lens;
  a.rows = Mn * B;
  a.out_score = (float*)out;
  return launch<false>(a, K, P, R, C, window, (cudaStream_t)stream);
}

// Pass 2: the best local score of one model on each window and its
// envelope; out: [5, B] int32 words (score as float32 bits, seq_from,
// seq_to, hmm_from, hmm_to). window: the least power of two >= band; 0 for
// the exact closure. K, P, R, C: the layout.
extern "C" int mfx_viterbi_scan(
    const void* msc, const void* isc, const void* tmm, const void* tim,
    const void* tdm, const void* tmi, const void* tii, const void* tmd,
    const void* cdd, const void* entry, int model_len, const void* seqs,
    const void* lengths, int B, int T, int Lp, int window, int K, int P, int R,
    int C, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  Args a = profile_args(msc, isc, tmm, tim, tdm, tmi, tii, tmd, cdd, entry, seqs,
                        lengths, B, T, Lp);
  a.model_len = model_len;
  a.rows = B;
  int32_t* o = (int32_t*)out;
  a.out_score = (float*)o;
  a.out_from = o + B;
  a.out_to = o + 2 * (int64_t)B;
  a.out_hmm_from = o + 3 * (int64_t)B;
  a.out_hmm_to = o + 4 * (int64_t)B;
  return launch<true>(a, K, P, R, C, window, (cudaStream_t)stream);
}
