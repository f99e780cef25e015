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
// operations a cell (the score lookup, five H candidates and the E
// candidate each with three path fields, E, F, H and the best), over
// q_len * t_len cells a hit; the inputs are a few bytes a base, so device
// memory is no limit. The work is serial along a row (F) and reaches back
// five bases (the frameshifts).
//
// Design (a simple one that is right; making it fast is later work):
// - one warp a hit; lane k owns kCols = 4 consecutive query columns of a
//   strip of kStrip = 128;
// - an anti-diagonal wavefront: at step st lane k works on base t = st - k,
//   its columns left to right, and hands its F (entering the next lane's
//   first column) to lane k + 1 by warp shuffles; a strip takes
//   t_len + (active lanes - 1) steps;
// - every column's last kRing = 8 rows of H and E (a value and three
//   fields, 16 bytes each) live in shared memory rings, 33 KB a warp;
//   a cell reads rows t-1 to t-5 of its left neighbour and row t-3 of its
//   own column. Lane k - 1 runs one base ahead of lane k and writes row
//   t + 1 while lane k reads rows t - 5 to t - 1 of the same column, so the
//   ring needs 7 rows; 8 keeps the index a mask. A __syncwarp between steps
//   orders the writes before the reads;
// - a query longer than a strip runs strip after strip, the rings reset to
//   NEG; the last lane of a strip writes each base's H and E of its last
//   column and the F leaving it (12 words) to a [B, T, 12] scratch row that
//   lane 0 of the next strip reads into ring column 0 (the column left of
//   the strip) at the same base; lane 0 reads base t at step t and the last
//   lane writes it at step t + 31, so one buffer serves every strip;
// - each lane keeps its best cell (value, column, base, fields), replaced on
//   a greater value or an equal value in an earlier column; a warp
//   reduction in the same launch picks the answer;
// - a row stops at its lengths: no cell at or past t_len or q_len is
//   computed, and none to the left or above reads one.
// ptxas -v at -O3 for sm_90a: 92 registers, no spill stores or loads, no
// stack, 33,024 bytes of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kCols = 4;
constexpr int kWarp = 32;
constexpr int kStrip = kCols * kWarp;
constexpr int kRing = 8;
constexpr int kBoundaryWords = 12;

// a score with the three path fields of the best path reaching it
struct Cell {
  float v;
  int qs, ts, sh;
};

__device__ __forceinline__ Cell make_cell(float v) {
  Cell c;
  c.v = v;
  c.qs = c.ts = c.sh = 0;
  return c;
}

__device__ __forceinline__ Cell shfl_up(const Cell& c) {
  const unsigned all = 0xffffffffu;
  Cell o;
  o.v = __shfl_up_sync(all, c.v, 1);
  o.qs = __shfl_up_sync(all, c.qs, 1);
  o.ts = __shfl_up_sync(all, c.ts, 1);
  o.sh = __shfl_up_sync(all, c.sh, 1);
  return o;
}

__device__ __forceinline__ Cell shfl_down(const Cell& c, int off) {
  const unsigned all = 0xffffffffu;
  Cell o;
  o.v = __shfl_down_sync(all, c.v, off);
  o.qs = __shfl_down_sync(all, c.qs, off);
  o.ts = __shfl_down_sync(all, c.ts, off);
  o.sh = __shfl_down_sync(all, c.sh, off);
  return o;
}

__device__ __forceinline__ void store_cell(int32_t* p, const Cell& c) {
  p[0] = __float_as_int(c.v);
  p[1] = c.qs; p[2] = c.ts; p[3] = c.sh;
}

__device__ __forceinline__ Cell load_cell(const int32_t* p) {
  Cell c;
  c.v = __int_as_float(p[0]);
  c.qs = p[1]; c.ts = p[2]; c.sh = p[3];
  return c;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kWarp)
genewise_kernel(const int8_t* __restrict__ queries, const int32_t* __restrict__ q_lens,
                const int8_t* __restrict__ target_aa, const int32_t* __restrict__ t_lens,
                const float* __restrict__ sub, int K, int B, int Lq, int T, int stop_code,
                float gap_open, float gap_extend, float fs_penalty, float stop_penalty,
                int32_t* scratch, int32_t* out) {
  // row t of ring column i (query column s0 - 1 + i) at [t & (kRing - 1)][i]
  __shared__ Cell sH[kRing][kStrip + 1];
  __shared__ Cell sE[kRing][kStrip + 1];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int qlen = clampi(q_lens[b], 0, Lq);
  const int tlen = clampi(t_lens[b], 0, T);
  const int8_t* qrow = queries + (int64_t)b * Lq;
  const int8_t* trow = target_aa + (int64_t)b * T;
  int32_t* bnd = scratch ? scratch + (int64_t)b * T * kBoundaryWords : nullptr;
  const float neg_stop = -stop_penalty;

  // this lane's best cell: value and path fields, column, base; column 0
  // at value 0 with zero fields is the answer when no cell is positive
  Cell best = make_cell(0.0f);
  int best_j = 0, best_t = 0;

  for (int s0 = 0; s0 < qlen; s0 += kStrip) {
    const int j0 = s0 + lane * kCols;
    const int n_strip = min(qlen - s0, kStrip);
    const int last_lane = (n_strip - 1) / kCols;
    const bool more = s0 + kStrip < qlen;
    // rows before 0, and the column left of the query, read NEG
    for (int i = lane; i < kRing * (kStrip + 1); i += kWarp) {
      sH[i / (kStrip + 1)][i % (kStrip + 1)] = make_cell(kNeg);
      sE[i / (kStrip + 1)][i % (kStrip + 1)] = make_cell(kNeg);
    }
    int qc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      qc[c] = j < qlen ? clampi((int)qrow[j], 0, K - 1) : 0;
    }
    __syncwarp();
    // F entering column j0 at this lane's base; left of column 0 it is NEG
    Cell lF = make_cell(kNeg);
    const int steps = tlen + last_lane;
    for (int st = 0; st < steps; ++st) {
      const int t = st - lane;
      const bool active = lane <= last_lane && t >= 0 && t < tlen;
      const int r = t & (kRing - 1);
      const int r3 = (t - 3) & (kRing - 1);
      if (active && lane == 0 && s0 > 0) {
        const int32_t* p = bnd + (int64_t)t * kBoundaryWords;
        sH[r][0] = load_cell(p);
        sE[r][0] = load_cell(p + 4);
        lF = load_cell(p + 8);
      }
      Cell f = lF;
      if (active) {
        const int a = trow[t];
        const bool stop = a == stop_code;
        const int ac = clampi(a, 0, K - 1);
        Cell h = make_cell(kNeg), e = h;   // the last computed column's
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = j0 + c;
          if (j < qlen) {
            const int i = j - s0 + 1;   // this column's ring column
            const float s = stop ? neg_stop : __ldg(sub + qc[c] * K + ac);
            Cell best_in;               // A[t,j] and its fields
            best_in.v = 0.0f;
            best_in.qs = j;
            best_in.ts = max(t - 2, 0);
            best_in.sh = 0;
#pragma unroll
            for (int k = 0; k < 5; ++k) {
              const int dt = k == 0 ? 3 : (k < 3 ? k : k + 1);   // 3, 1, 2, 4, 5
              const Cell hp = sH[(t - dt) & (kRing - 1)][i - 1];
              const float cand = (hp.v <= 0.0f ? kNeg : hp.v) - (dt == 3 ? 0.0f : fs_penalty);
              if (cand > best_in.v) {
                best_in = hp;
                best_in.v = cand;
                best_in.sh += dt == 3 ? 0 : 1;
              }
            }
            const Cell el = sE[r3][i - 1];
            if (el.v > best_in.v) best_in = el;
            // E: a codon gap along the DNA, staying at column j
            const Cell h3 = sH[r3][i];
            const Cell e3 = sE[r3][i];
            const float e_open = h3.v - gap_open;
            const float e_ext = e3.v - gap_extend;
            if (e_open >= e_ext) {
              e = h3;
              e.v = e_open;
            } else {
              e = e3;
              e.v = e_ext;
            }
            Cell hc = best_in;
            hc.v = s + best_in.v;
            // F entering this column replaces Hc only when greater
            h = f.v > hc.v ? f : hc;
            h.v = fmaxf(h.v, kNeg);
            if (h.v > best.v || (h.v == best.v && j < best_j)) {
              best = h;
              best_j = j;
              best_t = t;
            }
            // F entering column j + 1: extend f or open from Hc
            const float f_ext = f.v - gap_extend;
            const float f_open = hc.v - gap_open;
            if (f_ext >= f_open) {
              f.v = f_ext;
            } else {
              f = hc;
              f.v = f_open;
            }
            sH[r][i] = h;
            sE[r][i] = e;
          }
        }
        if (lane == last_lane && more) {
          // a full strip: the last lane's last column is column s0 + 127
          int32_t* p = bnd + (int64_t)t * kBoundaryWords;
          store_cell(p, h);
          store_cell(p + 4, e);
          store_cell(p + 8, f);
        }
      }
      // base t's F to the next lane, which works on t at the next step
      const Cell rF = shfl_up(f);
      if (lane > 0) lF = rF;
      __syncwarp();
    }
  }

  // the first column of the maximum, at its earliest base
  for (int off = 16; off > 0; off >>= 1) {
    const Cell o = shfl_down(best, off);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
    const int ot = __shfl_down_sync(0xffffffffu, best_t, off);
    if (o.v > best.v || (o.v == best.v && oj < best_j)) {
      best = o;
      best_j = oj;
      best_t = ot;
    }
  }
  if (lane == 0) {
    out[b] = __float_as_int(best.v);
    out[1 * (int64_t)B + b] = best.qs;
    out[2 * (int64_t)B + b] = best_j;
    out[3 * (int64_t)B + b] = best.ts;
    out[4 * (int64_t)B + b] = best_t;
    out[5 * (int64_t)B + b] = best.sh;
  }
}

}  // namespace

// Aligns query row b with the translated target row b for every b < B.
// queries [B, Lq] int8 aa codes, target_aa [B, T] int8 (the aa of the codon
// ending at each base), q_lens and t_lens [B] int32 (clamped to [0, Lq] and
// [0, T]), sub [K, K] float32, stop_code the aa code of a stop codon;
// scratch: [B, T, 12] int32 when Lq > 128, else unused (may be null); out:
// [6, B] int32 words (score as float32 bits, q_from, q_to, t_from, t_to,
// frameshifts).
extern "C" int mfx_genewise_align(const void* queries, const void* q_lens,
                                  const void* target_aa, const void* t_lens, const void* sub,
                                  int K, int B, int Lq, int T, int stop_code, float gap_open,
                                  float gap_extend, float fs_penalty, float stop_penalty,
                                  void* scratch, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || Lq < 0 || T < 0 || (Lq > kStrip && T > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  genewise_kernel<<<B, kWarp, 0, (cudaStream_t)stream>>>(
      (const int8_t*)queries, (const int32_t*)q_lens, (const int8_t*)target_aa,
      (const int32_t*)t_lens, (const float*)sub, K, B, Lq, T, stop_code, gap_open,
      gap_extend, fs_penalty, stop_penalty, (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}
