// Batched affine-gap local alignment (Smith-Waterman) for Hopper (sm_90a).
//
// Replaces the XLA lax.scan of mitoflex_tpu/ops/sw.py sw_align (:60; the
// scan :212 over step :101, the F closure an associative_scan :165). In the
// port its plain version is mitoflex_tpu_torch/ops/sw.py sw_align_plain, a
// Python loop of tensor steps, one step (a few dozen eager launches plus
// log2(Lq) prefix-max rounds) a target position. Here one launch aligns
// every (query, target) pair of a batch.
//
// The recurrence, per target position t and query column j (NEG = -1e30):
//   E[t,j]  = max(H[t-1,j] - open, E[t-1,j] - ext)                (open on ties)
//   H'[t,j] = max(max(H[t-1,j-1], 0) + s(q_j, x_t), E[t,j])   (diagonal on ties)
//   F[t,j]  = max(H'[t,j-1] - open, F[t,j-1] - ext)           (extension on ties)
//   H[t,j]  = max(F if F > H' else H', 0)
// The plain version's F is the prefix form max_{i<j}(H'[i] + ext*i) - ext*j
// - (open - ext) with the leftmost maximum; the sequential form above gives
// the same value and the same origin column. A fresh start (column 0, or
// H[t-1,j-1] <= 0; column 0's left neighbour holds 0) takes the path fields
// (j, t, 0, 0, 0, 0); a diagonal move adds the match flag (the clamped
// query code against the raw target code) to ident and 1 to cols; an E or
// F column adds 1 to cols and gap cols, and 1 to gap opens where it opens.
// Substitution scores are sub[clamp(q)][clamp(x)]. The answer is the first
// column holding the maximum H, at the earliest position of that column:
// the plain version's per-column best (replaced only on a strictly greater
// H) and its first-max pick.
//
// Only cells with H > 0 reach an output, and with integer scores and gap
// costs (all the pipeline uses) every such value is an integer-valued
// float32 sum far below 2^24, so every order of adding gives the same bits:
// the kernel is bit-equal to the plain version in all nine fields.
//
// What bounds it on the H100: ALU work, about 61 float32 and int32
// operations a cell (chip_smoke.py SW_OPS_PER_CELL), over q_len * t_len
// cells a pair, at 67 TFLOP/s; the inputs are a few bytes a position, so
// device memory is no limit. But each cell waits for its left neighbour's F
// and its upper neighbour's E, so what decides a call's time is its chain:
// about Lt + 32 x (the query's strips) steps of one stage, each step a
// lane's C columns, the slot's shuffles and the hand-off.
//
// Design: a pair's columns run as a pipeline of warp stages
// (row_pipeline.cuh): lane l of a stage owns C = 1, 2 or 4 columns and
// takes RW = 1 or 2 target positions a step (RW 2 at C <= 2), a stage a
// strip of 32 C, a pair's stages the P warps of a block times the blocks of
// a cluster, wrapping round through a [B, ceil(Lt / RW), slot] row in
// device memory where the query has more strips than the pair has stages.
// ops/sw.py sw_config picks (C, P, cluster, wide, RW) from the widths, the
// layout whose chain is shortest in measured step costs: long targets one
// column and two positions a lane and as many stages as strips, long
// queries against short targets four columns (fewer strips to fill). A
// block is one pair; the call's pairs are its blocks.
// - The six path fields ride as three 32-bit words, qs | ts << 16,
//   id | nc << 16 and go | gc << 16, so a move adds one packed constant
//   (E and F: nc + 1 and gc + 1, go + 1 where it opens; the diagonal:
//   id + the match flag and nc + 1), a cell is 4 words and a lane hands 8
//   words right a step. No field can carry into its neighbour while each
//   stays below 65,536: a path's cols are at most Lq + Lt, so the packed
//   instantiation takes Lq + Lt <= 65,535, and a wide one (six words, the
//   fields unpacked) any longer row.
// - A lane hands right, each step, the F leaving its last column and that
//   column's H: lane l + 1 reads the F at once and the H as the diagonal of
//   the next position.
// What limits a call now is its chain, Lt / RW + 32 x strips stage steps
// (its rounds' passes of the target where the strips wrap), at 450-1,050 ns
// a step on an H100 (scripts/torch_kernel_bench.py): a lone warp's step is
// its cells plus fixed per-step work and, between stages, the hand-off,
// each instruction's latency exposed.
// ptxas -v at -O3 for sm_90a (shared memory is dynamic: the [K, K] table,
// then kDepth (8) x RW x 8 (14 wide) words x 8 bytes + 64 a warp, 576
// (960) bytes at RW 1): packed, (C, RW) = (1, 1) / (2, 1) / (4, 1) /
// (1, 2) / (2, 2) at 127 / 127 / 161 / 167 / 168 registers; wide 167 /
// 167 / 229 / 255 / 255, (2, 2) with 16 bytes of stack and 12 of spill
// stores; the others no spills, no stack.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_pipeline.cuh"

namespace {

using rp::Best;
using rp::Cell;
using rp::cell;
using rp::enslot;
using rp::sel;
using rp::unslot;

constexpr int kPackLimit = 65535;  // Lq + Lt at most with packed path fields

// path words: packed (qs | ts << 16, id | nc << 16, go | gc << 16) or wide
// (qs, ts, id, nc, go, gc)
template <bool WIDE>
struct SwPath {
  static constexpr int N = WIDE ? 6 : 3;

  __device__ static __forceinline__ void fresh(Cell<N>& c, int j, int t) {
    if constexpr (WIDE) {
      c.w[0] = (uint32_t)j;
      c.w[1] = (uint32_t)t;
      c.w[2] = c.w[3] = c.w[4] = c.w[5] = 0;
    } else {
      c.w[0] = (uint32_t)j | ((uint32_t)t << 16);
      c.w[1] = c.w[2] = 0;
    }
  }
  // a diagonal move: ident + match, cols + 1
  __device__ static __forceinline__ void diag(Cell<N>& c, uint32_t match) {
    if constexpr (WIDE) {
      c.w[2] += match;
      c.w[3] += 1;
    } else {
      c.w[1] += match + (1u << 16);
    }
  }
  // a gap column (E along the target, F along the query): cols + 1, gap
  // cols + 1, gap opens + open
  __device__ static __forceinline__ void gap(Cell<N>& c, uint32_t open) {
    if constexpr (WIDE) {
      c.w[3] += 1;
      c.w[4] += open;
      c.w[5] += 1;
    } else {
      c.w[1] += 1u << 16;
      c.w[2] += open + (1u << 16);
    }
  }
  // field f (qs, ts, id, nc, go, gc) of a cell's words
  __device__ static __forceinline__ int field(const uint32_t (&w)[N], int f) {
    if constexpr (WIDE) return (int)w[f];
    else return (int)((f & 1) ? w[f >> 1] >> 16 : w[f >> 1] & 0xffffu);
  }
};

template <int C_, int ROWS, bool WIDE>
struct SwRec {
  static constexpr int C = C_;
  static constexpr int kRows = ROWS;
  using P = SwPath<WIDE>;
  static constexpr int N = P::N;
  static constexpr int kRowWords = 2 * (1 + N);    // F leaving, the last column's H
  static constexpr int kSlot = ROWS * kRowWords;
  static constexpr bool kStop = false;
  using CellT = Cell<N>;

  struct Lane {
    CellT H[C], E[C];  // the lane's columns at the last position
    CellT lF[ROWS];    // F entering the first column at each of the block's positions
    CellT lH[ROWS];    // H of the column on the left there
    CellT dg;          // ... at the position before the block (the diagonal)
    CellT fo[ROWS];    // F leaving the last column, at each position
    CellT ho[ROWS];    // H of the last column, at each position
  };

  __device__ static __forceinline__ void reset(Lane& L) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      L.H[c] = cell<N>(0.0f);
      L.E[c] = cell<N>(rp::kNeg);
    }
    // left of column 0: F NEG, H 0 (a fresh start)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      L.lF[r] = L.fo[r] = cell<N>(rp::kNeg);
      L.lH[r] = L.ho[r] = cell<N>(0.0f);
    }
    L.dg = cell<N>(0.0f);
  }

  // the slot into the lane where ``in``
  __device__ static __forceinline__ void take(Lane& L, const uint32_t (&w)[kSlot], bool in) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      L.lF[r] = sel(in, unslot<N>(w, r * kRowWords), L.lF[r]);
      L.lH[r] = sel(in, unslot<N>(w, r * kRowWords + 1 + N), L.lH[r]);
    }
  }

  __device__ static __forceinline__ void put(const Lane& L, uint32_t (&w)[kSlot]) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      enslot(w, r * kRowWords, L.fo[r]);
      enslot(w, r * kRowWords + 1 + N, L.ho[r]);
    }
  }

  // the lane's columns over block u (positions ROWS u + r), row by row:
  // every column computed, its state committed where it lies inside the
  // query, the best offered cells inside the query and the target (selects,
  // no branch)
  __device__ static __forceinline__ void step(Lane& L, Best<N>& best, int u, int j0, int qlen,
                                              int tlen, const int (&x)[ROWS],
                                              const int (&qc)[C], const float (&s)[ROWS][C],
                                              const rp::Pen& p) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = u * ROWS + r;
      const bool t_in = t < tlen;
      CellT f = L.lF[r];
      CellT dg = r == 0 ? L.dg : L.lH[r > 0 ? r - 1 : 0];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const bool in = j < qlen;
        const CellT h_old = L.H[c];
        // E: a gap along the target, staying at column j
        const float e_open = h_old.v - p.go;
        const float e_ext = L.E[c].v - p.ge;
        const bool eo = e_open >= e_ext;
        CellT e = sel(eo, h_old, L.E[c]);
        e.v = eo ? e_open : e_ext;
        P::gap(e, eo ? 1u : 0u);
        // the diagonal; a fresh start is a diagonal move from score 0
        const bool fresh = dg.v <= 0.0f;
        CellT d = dg;
        P::fresh(d, j, t);
        d = sel(fresh, d, dg);
        const float cand = (fresh ? 0.0f : dg.v) + s[r][c];
        P::diag(d, qc[c] == x[r] ? 1u : 0u);
        const bool ud = cand >= e.v;
        CellT hp = sel(ud, d, e);
        hp.v = ud ? cand : e.v;
        // F entering this column replaces H' only when greater
        CellT h = sel(f.v > hp.v, f, hp);
        h.v = fmaxf(h.v, 0.0f);
        rp::offer(best, h, j, t, in && t_in);
        // F entering column j + 1: extend f or open from H'
        const float f_ext = f.v - p.ge;
        const float f_open = hp.v - p.go;
        const bool fo = !(f_ext >= f_open);
        CellT nf = sel(fo, hp, f);
        nf.v = fo ? f_open : f_ext;
        P::gap(nf, fo ? 1u : 0u);
        L.E[c] = sel(in, e, L.E[c]);
        L.H[c] = sel(in, h, h_old);
        f = sel(in, nf, f);
        dg = sel(in, h_old, dg);
      }
      L.fo[r] = f;
      L.ho[r] = L.H[C - 1];
    }
    L.dg = L.lH[ROWS - 1];
  }

  // out: [9, B] int32 words (score as float32 bits, q_from, q_to, t_from,
  // t_to, ident, cols, gap opens, gap cols)
  __device__ static __forceinline__ void write(const Best<N>& b, int32_t* out, int B, int row) {
    out[row] = __float_as_int(b.v);
    out[1 * (int64_t)B + row] = P::field(b.w, 0);
    out[2 * (int64_t)B + row] = b.j;
    out[3 * (int64_t)B + row] = P::field(b.w, 1);
    out[4 * (int64_t)B + row] = b.t;
    out[5 * (int64_t)B + row] = P::field(b.w, 2);
    out[6 * (int64_t)B + row] = P::field(b.w, 3);
    out[7 * (int64_t)B + row] = P::field(b.w, 4);
    out[8 * (int64_t)B + row] = P::field(b.w, 5);
  }
};

// the instantiations: 1, 2 or 4 columns a lane at one position a step, 1
// or 2 columns at two
template <bool WIDE>
int launch_layout(int cols, int rows, const rp::Args& a, const rp::Layout& L,
                  cudaStream_t stream) {
  switch (cols * 10 + rows) {
    case 11: return rp::launch<SwRec<1, 1, WIDE>>(a, L, stream);
    case 21: return rp::launch<SwRec<2, 1, WIDE>>(a, L, stream);
    case 41: return rp::launch<SwRec<4, 1, WIDE>>(a, L, stream);
    case 12: return rp::launch<SwRec<1, 2, WIDE>>(a, L, stream);
    case 22: return rp::launch<SwRec<2, 2, WIDE>>(a, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory bytes a block of the layout takes (ops/sw.py's
// sw_smem_bytes mirrors this; chip_smoke.py holds the two equal).
extern "C" long long mfx_sw_smem_bytes(int K, int warps, int wide, int rows) {
  const int row_words = wide ? SwRec<1, 1, true>::kSlot : SwRec<1, 1, false>::kSlot;
  return (long long)rp::smem_bytes(K, false, warps, rows * row_words);
}

// Aligns query row b with target row b for every b < B. queries [B, Lq] and
// targets [B, Lt] int8 codes, q_lens and t_lens [B] int32 (clamped to
// [0, Lq] and [0, Lt]), sub [K, K] float32; the layout (ops/sw.py
// sw_config): cols a lane, warps (stages) of a pair in a block, cluster
// size, wide path fields (required when Lq + Lt > 65535), target positions
// a lane a step (rows); scratch: [B, ceil(Lt / rows), rows x (8 or 14
// wide)] 64-bit words when the query has more strips than the pair has
// stages, else unused (may be null); out: [9, B] int32 words (score as
// float32 bits, q_from, q_to, t_from, t_to, ident, cols, gap opens, gap
// cols).
extern "C" int mfx_sw_align(const void* queries, const void* q_lens, const void* targets,
                            const void* t_lens, const void* sub, int K, int B, int Lq,
                            int Lt, float gap_open, float gap_extend, int cols, int warps,
                            int cluster, int wide, int rows, void* scratch, void* out,
                            void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (!wide && (int64_t)Lq + Lt > kPackLimit) return (int)cudaErrorInvalidValue;
  rp::Args a = {};
  a.queries = (const int8_t*)queries;
  a.q_lens = (const int32_t*)q_lens;
  a.targets = (const int8_t*)targets;
  a.t_lens = (const int32_t*)t_lens;
  a.sub = (const float*)sub;
  a.K = K;
  a.B = B;
  a.Lq = Lq;
  a.Lt = Lt;
  a.stop_code = 0;
  a.go = gap_open;
  a.ge = gap_extend;
  a.scratch = (uint64_t*)scratch;
  a.out = (int32_t*)out;
  const rp::Layout L = {warps, cluster};
  return wide ? launch_layout<true>(cols, rows, a, L, (cudaStream_t)stream)
              : launch_layout<false>(cols, rows, a, L, (cudaStream_t)stream);
}
