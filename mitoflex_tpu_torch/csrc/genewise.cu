// Codon-aware, frameshift-tolerant protein-vs-DNA local alignment (the
// genewise equivalent) for Hopper (sm_90a).
//
// Replaces the XLA lax.scan of mitoflex_tpu/ops/genewise.py genewise_align
// (:75; the scan :215 over step :114, the F closure an associative_scan
// :186). In the port its plain version is mitoflex_tpu_torch/ops/genewise.py
// genewise_align_plain, a Python loop of tensor steps, about 116 eager
// launches a target base. Here one launch aligns every hit of a call.
//
// The recurrence, per target base t and query column j (NEG = -1e30; aa_t
// is the amino acid of the codon ending at base t):
//   s[t,j]  = -stop_penalty where aa_t is the stop code,
//             else sub[clamp(q_j)][clamp(aa_t)]
//   A[t,j]  = the best of these candidates, in this order, a later one
//             replacing only when strictly greater:
//               0, a fresh start, fields (j, max(t - 2, 0), 0);
//               H[t-3,j-1], a codon match;
//               H[t-dt,j-1] - fs for dt = 1, 2, 4, 5, a frameshift, adding 1
//               to the frameshift count;
//               E[t-3,j-1], a codon gap closed by a match;
//             an H at or below 0 counts as NEG there (restarts are the 0
//             candidate's)
//   Hc[t,j] = s[t,j] + A[t,j]
//   E[t,j]  = max(H[t-3,j] - open, E[t-3,j] - ext)            (open on ties)
//   F[t,j]  = max(Hc[t,j-1] - open, F[t,j-1] - ext)       (extension on ties)
//   H[t,j]  = max(F if F > Hc else Hc, NEG)
// Rows before 0 read NEG, and so do the columns left of the query. Each
// value carries three path fields (query start, target start, frameshift
// count): E takes its origin's, F the fields of the Hc it opened from. The
// plain version's F is the prefix form max_{i<j}(Hc[i] + ext*i) - ext*j -
// (open - ext) with the leftmost maximum (sw.prefix_argmax); the sequential
// form above gives the same value and the same origin column. The answer is
// the first column holding the largest H above 0, at the earliest base of
// that column (the plain version's per-column best, replaced only on a
// strictly greater H, and its first-max pick); score 0 and zero fields
// where no H is positive.
//
// Equality: with integer substitution scores and penalties (all the
// pipeline uses: BLOSUM62 at 13/3/15/20) every live value is an
// integer-valued float32 far below 2^24, so every order of adding gives the
// same bits, and NEG absorbs every penalty; the kernel is bit-equal to the
// plain version in all six fields. With other penalties the two forms of F
// may differ in the last bits of a score (tests/test_torch_genewise.py
// holds the plain version against the JAX package within 1e-4).
//
// What bounds it on the H100: ALU work, about 81 float32 and int32
// operations a cell (chip_smoke.py GENEWISE_OPS_PER_CELL), over q_len *
// t_len cells a hit, at 67 TFLOP/s; the inputs are a few bytes a base, so
// device memory is no limit. But F is serial along a row and a cell reaches
// back five bases, so what decides a call's time is its chain: about T +
// 32 x (the query's strips) steps of one stage.
//
// Design: a hit's columns run as a pipeline of warp stages
// (row_pipeline.cuh, as sw.cu): lane l of a stage owns C = 1, 2 or 4
// columns and takes RW = 1 or 2 bases a step (RW 2 at C <= 2);
// ops/genewise.py genewise_config picks the layout.
// - The history a cell reads back lives in registers: each lane keeps H at
//   t-1 .. t-5 and E at t-1 .. t-3 of its own columns, and of the column on
//   its left (the left lane's last column, or the previous stage's), which
//   arrives one base a step in the slot a lane hands right: the F leaving
//   its last column, and that column's H and E at the base. A lane reads
//   the F at once and shifts the H and E into its left history after the
//   base. No shared memory holds a row of cells.
// - The three path fields ride as two 32-bit words, qs | ts << 16 and the
//   frameshift count, so a cell is 3 words and a slot 9 (10 in a ring, 16-byte aligned). No field can carry
//   into its neighbour while Lq and T are each at most 65,535; a wide
//   instantiation (three words) takes longer rows.
// What limits a call now is its chain, T / RW + 32 x strips stage steps,
// at 600-1,150 ns a step on an H100 (as sw.cu: the cells, fixed per-step
// work and the hand-off between stages, each latency exposed).
// ptxas -v at -O3 for sm_90a (shared memory is dynamic: the [K, K + 1]
// table, then kDepth (8) x RW x 9 (12 wide) words rounded up to even x 8
// bytes + 64 a warp, 704 (832) bytes at RW 1): packed, (C, RW) =
// (1, 1) / (2, 1) / (4, 1) / (1, 2) / (2, 2) at 167 / 166 / 255 / 247 /
// 255 registers, no spills; wide 211 / 235 / 255 / 255 / 255, and at (4, 1)
// and (2, 2) 144 and 168 bytes of stack with 260 and 320 bytes of spill
// stores (taken only past 65,535 columns or bases).

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

constexpr int kPackLimit = 65535;  // Lq and T at most with packed path fields
constexpr int kHist = 5;           // bases of H a cell reads back
constexpr int kEHist = 3;          // ... of E

// path words: packed (qs | ts << 16, shifts) or wide (qs, ts, shifts)
template <bool WIDE>
struct WisePath {
  static constexpr int N = WIDE ? 3 : 2;

  // a fresh start at column j, base t: (j, max(t - 2, 0), 0)
  __device__ static __forceinline__ void fresh(Cell<N>& c, int j, int t) {
    const int ts = t > 2 ? t - 2 : 0;
    if constexpr (WIDE) {
      c.w[0] = (uint32_t)j;
      c.w[1] = (uint32_t)ts;
      c.w[2] = 0;
    } else {
      c.w[0] = (uint32_t)j | ((uint32_t)ts << 16);
      c.w[1] = 0;
    }
  }
  __device__ static __forceinline__ void shift(Cell<N>& c) { c.w[N - 1] += 1; }
  // field f (qs, ts, shifts) of a cell's words
  __device__ static __forceinline__ int field(const uint32_t (&w)[N], int f) {
    if constexpr (WIDE) return (int)w[f];
    else return f == 2 ? (int)w[1] : (int)(f ? w[0] >> 16 : w[0] & 0xffffu);
  }
};

template <int C_, int ROWS, bool WIDE>
struct WiseRec {
  static constexpr int C = C_;
  static constexpr int kRows = ROWS;
  using P = WisePath<WIDE>;
  static constexpr int N = P::N;
  static constexpr int kRowWords = 3 * (1 + N);  // F leaving, the last column's H and E
  static constexpr int kSlot = ROWS * kRowWords;
  static constexpr bool kStop = true;
  using CellT = Cell<N>;

  struct Lane {
    CellT Hh[C][kHist];  // H of the lane's columns at the block's p0-1 .. p0-5
    CellT Eh[C][kEHist]; // E at p0-1 .. p0-3
    CellT Lh[kHist];     // the column on the left: H at p0-1 .. p0-5
    CellT Le[kEHist];    // E at p0-1 .. p0-3
    CellT lF[ROWS];      // F entering the first column at the block's bases
    CellT pH[ROWS], pE[ROWS];  // the column on the left at them
    CellT fo[ROWS], ho[ROWS], eo[ROWS];  // F leaving the last column, its H and E
  };

  __device__ static __forceinline__ void reset(Lane& L) {
    const CellT neg = cell<N>(rp::kNeg);
#pragma unroll
    for (int k = 0; k < kHist; ++k) {
      L.Lh[k] = neg;
#pragma unroll
      for (int c = 0; c < C; ++c) L.Hh[c][k] = neg;
    }
#pragma unroll
    for (int k = 0; k < kEHist; ++k) {
      L.Le[k] = neg;
#pragma unroll
      for (int c = 0; c < C; ++c) L.Eh[c][k] = neg;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) L.lF[r] = L.pH[r] = L.pE[r] = L.fo[r] = L.ho[r] = L.eo[r] = neg;
  }

  // the slot into the lane where ``in``
  __device__ static __forceinline__ void take(Lane& L, const uint32_t (&w)[kSlot], bool in) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      L.lF[r] = sel(in, unslot<N>(w, r * kRowWords), L.lF[r]);
      L.pH[r] = sel(in, unslot<N>(w, r * kRowWords + 1 + N), L.pH[r]);
      L.pE[r] = sel(in, unslot<N>(w, r * kRowWords + 2 * (1 + N)), L.pE[r]);
    }
  }

  __device__ static __forceinline__ void put(const Lane& L, uint32_t (&w)[kSlot]) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      enslot(w, r * kRowWords, L.fo[r]);
      enslot(w, r * kRowWords + 1 + N, L.ho[r]);
      enslot(w, r * kRowWords + 2 * (1 + N), L.eo[r]);
    }
  }

  // the lane's columns over block u (bases ROWS u + r), base by base: every
  // column computed, its cells kept where it lies inside the query, the
  // best offered cells inside the query and the target (selects, no
  // branch)
  __device__ static __forceinline__ void step(Lane& L, Best<N>& best, int u, int j0, int qlen,
                                              int tlen, const int (&/*x*/)[ROWS],
                                              const int (&/*qc*/)[C],
                                              const float (&s)[ROWS][C], const rp::Pen& p) {
    if constexpr (ROWS == 1)
      step1(L, best, u, j0, qlen, s[0], p);
    else
      step_block(L, best, u, j0, qlen, tlen, s, p);
  }

  // one base a step (block u is base u, always inside the target): the
  // cells of the column on the left come from the histories alone (kept
  // apart from step_block, which at one base a step the compiler leaves in
  // local memory)
  __device__ static __forceinline__ void step1(Lane& L, Best<N>& best, int t, int j0, int qlen,
                                               const float (&s)[C], const rp::Pen& p) {
    const CellT neg = cell<N>(rp::kNeg);
    CellT f = L.lF[0];
    CellT hn[C], en[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const bool in = j < qlen;
      // A[t,j]: the start, then dt = 3, 1, 2, 4, 5, then E[t-3,j-1]
      CellT a = cell<N>(0.0f);
      P::fresh(a, j, t);
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int dt = q == 0 ? 3 : (q < 3 ? q : q + 1);
        const CellT& hp = c == 0 ? L.Lh[dt - 1] : L.Hh[c > 0 ? c - 1 : 0][dt - 1];
        const float cand = (hp.v <= 0.0f ? rp::kNeg : hp.v) - (dt == 3 ? 0.0f : p.fs);
        CellT o = hp;
        if (dt != 3) P::shift(o);
        const bool take = cand > a.v;
        a = sel(take, o, a);
        a.v = take ? cand : a.v;
      }
      const CellT& el = c == 0 ? L.Le[2] : L.Eh[c > 0 ? c - 1 : 0][2];
      a = sel(el.v > a.v, el, a);
      // E: a codon gap along the DNA, staying at column j
      const CellT& h3 = L.Hh[c][2];
      const CellT& e3 = L.Eh[c][2];
      const float e_open = h3.v - p.go;
      const float e_ext = e3.v - p.ge;
      const bool eo = e_open >= e_ext;
      CellT e = sel(eo, h3, e3);
      e.v = eo ? e_open : e_ext;
      CellT hc = a;
      hc.v = s[c] + a.v;
      // F entering this column replaces Hc only when greater
      CellT h = sel(f.v > hc.v, f, hc);
      h.v = fmaxf(h.v, rp::kNeg);
      rp::offer(best, h, j, t, in);
      // F entering column j + 1: extend f or open from Hc
      const float f_ext = f.v - p.ge;
      const float f_open = hc.v - p.go;
      const bool fo = !(f_ext >= f_open);
      CellT nf = sel(fo, hc, f);
      nf.v = fo ? f_open : f_ext;
      f = sel(in, nf, f);
      hn[c] = sel(in, h, neg);
      en[c] = sel(in, e, neg);
    }
    // the histories move on one base
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = kHist - 1; k > 0; --k) L.Hh[c][k] = L.Hh[c][k - 1];
      L.Hh[c][0] = hn[c];
#pragma unroll
      for (int k = kEHist - 1; k > 0; --k) L.Eh[c][k] = L.Eh[c][k - 1];
      L.Eh[c][0] = en[c];
    }
#pragma unroll
    for (int k = kHist - 1; k > 0; --k) L.Lh[k] = L.Lh[k - 1];
    L.Lh[0] = L.pH[0];
#pragma unroll
    for (int k = kEHist - 1; k > 0; --k) L.Le[k] = L.Le[k - 1];
    L.Le[0] = L.pE[0];
    L.fo[0] = f;
    L.ho[0] = hn[C - 1];
    L.eo[0] = en[C - 1];
  }

  // ROWS bases a step. A cell at base p0 + r reads back to p0 + r - 5: bases
  // inside the block come from this step's cells (the left column's from
  // its slot), the rest from the histories.
  __device__ static __forceinline__ void step_block(Lane& L, Best<N>& best, int u, int j0,
                                                    int qlen, int tlen,
                                                    const float (&s)[ROWS][C],
                                                    const rp::Pen& p) {
    const CellT neg = cell<N>(rp::kNeg);
    CellT hn[ROWS][C], en[ROWS][C];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int t = u * ROWS + r;
      const bool t_in = t < tlen;
      CellT f = L.lF[r];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const bool in = j < qlen;
        // A[t,j]: the start, then dt = 3, 1, 2, 4, 5, then E[t-3,j-1]; H and E
        // of column c - 1 (the left column for c == 0) at base p0 + r - dt
        // (copies, every index fixed at compile time)
        CellT a = cell<N>(0.0f);
        P::fresh(a, j, t);
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const int dt = q == 0 ? 3 : (q < 3 ? q : q + 1);
          const int i = r - dt;
          const int in_blk = i >= 0 ? i : 0, back = i < 0 ? -i - 1 : 0;
          const int cl = c > 0 ? c - 1 : 0;
          const CellT hp = c == 0 ? (i >= 0 ? L.pH[in_blk] : L.Lh[back])
                                  : (i >= 0 ? hn[in_blk][cl] : L.Hh[cl][back]);
          const float cand = (hp.v <= 0.0f ? rp::kNeg : hp.v) - (dt == 3 ? 0.0f : p.fs);
          CellT o = hp;
          if (dt != 3) P::shift(o);
          const bool take = cand > a.v;
          a = sel(take, o, a);
          a.v = take ? cand : a.v;
        }
        const int i3 = r - 3;
        const int i3b = i3 >= 0 ? i3 : 0, b3 = i3 < 0 ? -i3 - 1 : 0;
        const int cl = c > 0 ? c - 1 : 0;
        const CellT e3l = c == 0 ? (i3 >= 0 ? L.pE[i3b] : L.Le[b3])
                                 : (i3 >= 0 ? en[i3b][cl] : L.Eh[cl][b3]);
        a = sel(e3l.v > a.v, e3l, a);
        // E: a codon gap along the DNA, staying at column j
        const CellT h3 = i3 >= 0 ? hn[i3b][c] : L.Hh[c][b3];
        const CellT e3 = i3 >= 0 ? en[i3b][c] : L.Eh[c][b3];
        const float e_open = h3.v - p.go;
        const float e_ext = e3.v - p.ge;
        const bool eo = e_open >= e_ext;
        CellT e = sel(eo, h3, e3);
        e.v = eo ? e_open : e_ext;
        CellT hc = a;
        hc.v = s[r][c] + a.v;
        // F entering this column replaces Hc only when greater
        CellT h = sel(f.v > hc.v, f, hc);
        h.v = fmaxf(h.v, rp::kNeg);
        rp::offer(best, h, j, t, in && t_in);
        // F entering column j + 1: extend f or open from Hc
        const float f_ext = f.v - p.ge;
        const float f_open = hc.v - p.go;
        const bool fo = !(f_ext >= f_open);
        CellT nf = sel(fo, hc, f);
        nf.v = fo ? f_open : f_ext;
        f = sel(in, nf, f);
        hn[r][c] = sel(in, h, neg);
        en[r][c] = sel(in, e, neg);
      }
      L.fo[r] = f;
      L.ho[r] = hn[r][C - 1];
      L.eo[r] = en[r][C - 1];
    }
    // the histories move on ROWS bases (the newest first)
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = kHist - 1; k >= 0; --k)
        L.Hh[c][k] = k < ROWS ? hn[ROWS - 1 - (k < ROWS ? k : 0)][c] : L.Hh[c][k >= ROWS ? k - ROWS : 0];
#pragma unroll
      for (int k = kEHist - 1; k >= 0; --k)
        L.Eh[c][k] = k < ROWS ? en[ROWS - 1 - (k < ROWS ? k : 0)][c] : L.Eh[c][k >= ROWS ? k - ROWS : 0];
    }
#pragma unroll
    for (int k = kHist - 1; k >= 0; --k)
      L.Lh[k] = k < ROWS ? L.pH[ROWS - 1 - (k < ROWS ? k : 0)] : L.Lh[k >= ROWS ? k - ROWS : 0];
#pragma unroll
    for (int k = kEHist - 1; k >= 0; --k)
      L.Le[k] = k < ROWS ? L.pE[ROWS - 1 - (k < ROWS ? k : 0)] : L.Le[k >= ROWS ? k - ROWS : 0];
  }

  // out: [6, B] int32 words (score as float32 bits, q_from, q_to, t_from,
  // t_to, frameshifts)
  __device__ static __forceinline__ void write(const Best<N>& b, int32_t* out, int B, int row) {
    out[row] = __float_as_int(b.v);
    out[1 * (int64_t)B + row] = P::field(b.w, 0);
    out[2 * (int64_t)B + row] = b.j;
    out[3 * (int64_t)B + row] = P::field(b.w, 1);
    out[4 * (int64_t)B + row] = b.t;
    out[5 * (int64_t)B + row] = P::field(b.w, 2);
  }
};

// the instantiations: 1, 2 or 4 columns a lane at one base a step, 1 or 2
// columns at two
template <bool WIDE>
int launch_layout(int cols, int rows, const rp::Args& a, const rp::Layout& L,
                  cudaStream_t stream) {
  switch (cols * 10 + rows) {
    case 11: return rp::launch<WiseRec<1, 1, WIDE>>(a, L, stream);
    case 21: return rp::launch<WiseRec<2, 1, WIDE>>(a, L, stream);
    case 41: return rp::launch<WiseRec<4, 1, WIDE>>(a, L, stream);
    case 12: return rp::launch<WiseRec<1, 2, WIDE>>(a, L, stream);
    case 22: return rp::launch<WiseRec<2, 2, WIDE>>(a, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory bytes a block of the layout takes (ops/genewise.py's
// genewise_smem_bytes mirrors this; chip_smoke.py holds the two equal).
extern "C" long long mfx_genewise_smem_bytes(int K, int warps, int wide, int rows) {
  const int row_words = wide ? WiseRec<1, 1, true>::kSlot : WiseRec<1, 1, false>::kSlot;
  return (long long)rp::smem_bytes(K, true, warps, rows * row_words);
}

// Aligns query row b with the translated target row b for every b < B.
// queries [B, Lq] int8 aa codes, target_aa [B, T] int8 (the aa of the codon
// ending at each base), q_lens and t_lens [B] int32 (clamped to [0, Lq] and
// [0, T]), sub [K, K] float32, stop_code the aa code of a stop codon; the
// layout (ops/genewise.py genewise_config): cols a lane, warps (stages) of a
// hit in a block, cluster size, wide path fields (required when Lq or T
// exceeds 65535), bases a lane a step (rows);
// scratch: [B, ceil(T / rows), rows x (9 or 12 wide)] 64-bit words when the
// query has more strips than the hit has stages, else unused (may be
// null); out: [6, B] int32 words (score as float32
// bits, q_from, q_to, t_from, t_to, frameshifts).
extern "C" int mfx_genewise_align(const void* queries, const void* q_lens,
                                  const void* target_aa, const void* t_lens, const void* sub,
                                  int K, int B, int Lq, int T, int stop_code, float gap_open,
                                  float gap_extend, float fs_penalty, float stop_penalty,
                                  int cols, int warps, int cluster, int wide, int rows,
                                  void* scratch, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (!wide && (Lq > kPackLimit || T > kPackLimit)) return (int)cudaErrorInvalidValue;
  rp::Args a = {};
  a.queries = (const int8_t*)queries;
  a.q_lens = (const int32_t*)q_lens;
  a.targets = (const int8_t*)target_aa;
  a.t_lens = (const int32_t*)t_lens;
  a.sub = (const float*)sub;
  a.K = K;
  a.B = B;
  a.Lq = Lq;
  a.Lt = T;
  a.stop_code = stop_code;
  a.go = gap_open;
  a.ge = gap_extend;
  a.fs = fs_penalty;
  a.stop = stop_penalty;
  a.scratch = (uint64_t*)scratch;
  a.out = (int32_t*)out;
  const rp::Layout L = {warps, cluster};
  return wide ? launch_layout<true>(cols, rows, a, L, (cudaStream_t)stream)
              : launch_layout<false>(cols, rows, a, L, (cudaStream_t)stream);
}
