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
// H[t-1,j-1] <= 0) takes the path fields (j, t, 0, 0, 0, 0); a diagonal
// move adds the match flag (the clamped query code against the raw target
// code) to ident and 1 to cols; an E step 1 to cols and gap cols (and 1 to
// gap opens when it opens); an F gap of length g adds g to cols and gap cols
// and 1 to gap opens. Substitution scores are sub[clamp(q)][clamp(x)].
// The answer is the first column holding the maximum H, at the earliest
// position of that column: the plain version's per-column best (replaced
// only on a strictly greater H) and its first-max pick.
//
// Only cells with H > 0 reach an output, and with integer scores and gap
// costs (all the pipeline uses) every such value is an integer-valued
// float32 sum far below 2^24, so every order of adding gives the same bits:
// the kernel is bit-equal to the plain version in all nine fields.
//
// What bounds it on the H100: ALU work, about 60 float32 and int32
// operations a cell (score, E, H', F, H, and the six path fields selected
// along each), over q_len * t_len cells a pair; the inputs are a few bytes a
// position, so device memory is no limit. The work is serial along a row:
// each cell waits for its left neighbour's F.
//
// Design (a simple one that is right; making it fast is later work):
// - one warp a pair; lane k owns kCols = 4 consecutive query columns of a
//   strip of kStrip = 128, with their H and E states and path fields in
//   registers;
// - an anti-diagonal wavefront: at step st lane k works on target position
//   t = st - k, its columns left to right, and hands its F (entering the
//   next lane's first column) and its last column's H to lane k + 1 by
//   warp shuffles; a strip takes t_len + (active lanes - 1) steps; no
//   shared memory and no block barrier;
// - a query longer than a strip runs strip after strip; the last lane of a
//   strip writes each position's F and H (with their path fields, 14 words)
//   to a [B, Lt, 14] scratch row that lane 0 of the next strip reads; lane
//   0 reads position t at step t and the last lane writes it at step t + 31
//   or later, so one buffer serves every strip;
// - each lane keeps its best cell (value, column, position, path fields),
//   replaced on a greater value or an equal value in an earlier column; a
//   warp reduction in the same launch picks the answer;
// - a row stops at its lengths: positions at or past t_len leave H at 0 and
//   cannot change the best, and columns at or past q_len feed no column
//   inside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kCols = 4;
constexpr int kWarp = 32;
constexpr int kStrip = kCols * kWarp;
constexpr int kBoundaryWords = 14;

// a score with the six path fields of the best path reaching it
struct Cell {
  float v;
  int qs, ts, id, nc, go, gc;
};

__device__ __forceinline__ Cell make_cell(float v) {
  Cell c;
  c.v = v;
  c.qs = c.ts = c.id = c.nc = c.go = c.gc = 0;
  return c;
}

__device__ __forceinline__ Cell shfl_up(const Cell& c) {
  const unsigned all = 0xffffffffu;
  Cell o;
  o.v = __shfl_up_sync(all, c.v, 1);
  o.qs = __shfl_up_sync(all, c.qs, 1);
  o.ts = __shfl_up_sync(all, c.ts, 1);
  o.id = __shfl_up_sync(all, c.id, 1);
  o.nc = __shfl_up_sync(all, c.nc, 1);
  o.go = __shfl_up_sync(all, c.go, 1);
  o.gc = __shfl_up_sync(all, c.gc, 1);
  return o;
}

__device__ __forceinline__ Cell shfl_down(const Cell& c, int off) {
  const unsigned all = 0xffffffffu;
  Cell o;
  o.v = __shfl_down_sync(all, c.v, off);
  o.qs = __shfl_down_sync(all, c.qs, off);
  o.ts = __shfl_down_sync(all, c.ts, off);
  o.id = __shfl_down_sync(all, c.id, off);
  o.nc = __shfl_down_sync(all, c.nc, off);
  o.go = __shfl_down_sync(all, c.go, off);
  o.gc = __shfl_down_sync(all, c.gc, off);
  return o;
}

__device__ __forceinline__ void store_cell(int32_t* p, const Cell& c) {
  p[0] = __float_as_int(c.v);
  p[1] = c.qs; p[2] = c.ts; p[3] = c.id; p[4] = c.nc; p[5] = c.go; p[6] = c.gc;
}

__device__ __forceinline__ Cell load_cell(const int32_t* p) {
  Cell c;
  c.v = __int_as_float(p[0]);
  c.qs = p[1]; c.ts = p[2]; c.id = p[3]; c.nc = p[4]; c.go = p[5]; c.gc = p[6];
  return c;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kWarp)
sw_kernel(const int8_t* __restrict__ queries, const int32_t* __restrict__ q_lens,
          const int8_t* __restrict__ targets, const int32_t* __restrict__ t_lens,
          const float* __restrict__ sub, int K, int B, int Lq, int Lt,
          float gap_open, float gap_extend, int32_t* scratch, int32_t* out) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int qlen = clampi(q_lens[b], 0, Lq);
  const int tlen = clampi(t_lens[b], 0, Lt);
  const int8_t* qrow = queries + (int64_t)b * Lq;
  const int8_t* trow = targets + (int64_t)b * Lt;
  int32_t* bnd = scratch ? scratch + (int64_t)b * Lt * kBoundaryWords : nullptr;

  // this lane's best cell: value and path fields, column, position; column
  // 0 at value 0 with zero fields is the answer when no cell is positive
  Cell best = make_cell(0.0f);
  int best_j = 0, best_t = 0;

  for (int s0 = 0; s0 < qlen; s0 += kStrip) {
    const int j0 = s0 + lane * kCols;
    const int n_strip = min(qlen - s0, kStrip);
    const int last_lane = (n_strip - 1) / kCols;
    const bool more = s0 + kStrip < qlen;
    int qc[kCols];
    Cell H[kCols], E[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      qc[c] = j < qlen ? clampi((int)qrow[j], 0, K - 1) : 0;
      H[c] = make_cell(0.0f);
      E[c] = make_cell(kNeg);
    }
    // from the left: F entering column j0 at this position, H[t][j0-1] and
    // H[t-1][j0-1]; left of column 0 they are (NEG) and (0)
    Cell lF = make_cell(kNeg), lH = make_cell(0.0f), lHprev = make_cell(0.0f);
    const int steps = tlen + last_lane;
    for (int st = 0; st < steps; ++st) {
      const int t = st - lane;
      const bool active = lane <= last_lane && t >= 0 && t < tlen;
      if (active && lane == 0 && s0 > 0) {
        const int32_t* p = bnd + (int64_t)t * kBoundaryWords;
        lF = load_cell(p);
        lH = load_cell(p + 7);
      }
      Cell f = lF;
      if (active) {
        const int x = trow[t];
        const int xc = clampi(x, 0, K - 1);
        Cell dg = lHprev;  // H[t-1][j-1]
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = j0 + c;
          if (j < qlen) {
            const float s = __ldg(sub + qc[c] * K + xc);
            const Cell h_old = H[c];
            // E: a gap along the target, staying at column j
            const float e_open = h_old.v - gap_open;
            const float e_ext = E[c].v - gap_extend;
            if (e_open >= e_ext) {
              E[c] = h_old;
              E[c].v = e_open;
              E[c].go += 1;
            } else {
              E[c].v = e_ext;
            }
            E[c].nc += 1;
            E[c].gc += 1;
            // the diagonal; a fresh start is a diagonal move from score 0
            Cell d;
            if (j == 0 || dg.v <= 0.0f) {
              d = make_cell(0.0f);
              d.qs = j;
              d.ts = t;
            } else {
              d = dg;
            }
            const float cand = (j == 0 ? 0.0f : fmaxf(dg.v, 0.0f)) + s;
            d.id += qc[c] == x ? 1 : 0;
            d.nc += 1;
            Cell hp;
            if (cand >= E[c].v) {
              hp = d;
              hp.v = cand;
            } else {
              hp = E[c];
            }
            // F entering this column replaces H' only when greater
            Cell h = f.v > hp.v ? f : hp;
            h.v = fmaxf(h.v, 0.0f);
            if (h.v > best.v || (h.v == best.v && j < best_j)) {
              best = h;
              best_j = j;
              best_t = t;
            }
            // F entering column j + 1: extend f or open from H'
            const float f_ext = f.v - gap_extend;
            const float f_open = hp.v - gap_open;
            if (f_ext >= f_open) {
              f.v = f_ext;
            } else {
              f = hp;
              f.v = f_open;
              f.go += 1;
            }
            f.nc += 1;
            f.gc += 1;
            dg = h_old;
            H[c] = h;
          }
        }
        lHprev = lH;
        if (lane == last_lane && more) {
          int32_t* p = bnd + (int64_t)t * kBoundaryWords;
          store_cell(p, f);
          store_cell(p + 7, H[kCols - 1]);
        }
      }
      // position t's F and last-column H to the next lane, which works on t
      // at the next step
      const Cell rF = shfl_up(f);
      const Cell rH = shfl_up(H[kCols - 1]);
      if (lane > 0) {
        lF = rF;
        lH = rH;
      }
      __syncwarp();
    }
  }

  // the first column of the maximum, at its earliest position
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
    out[5 * (int64_t)B + b] = best.id;
    out[6 * (int64_t)B + b] = best.nc;
    out[7 * (int64_t)B + b] = best.go;
    out[8 * (int64_t)B + b] = best.gc;
  }
}

}  // namespace

// Aligns query row b with target row b for every b < B. queries [B, Lq] and
// targets [B, Lt] int8 codes, q_lens and t_lens [B] int32 (clamped to
// [0, Lq] and [0, Lt]), sub [K, K] float32; scratch: [B, Lt, 14] int32 when
// Lq > 128, else unused (may be null); out: [9, B] int32 words (score as
// float32 bits, q_from, q_to, t_from, t_to, ident, cols, gap opens, gap
// cols).
extern "C" int mfx_sw_align(const void* queries, const void* q_lens, const void* targets,
                            const void* t_lens, const void* sub, int K, int B, int Lq,
                            int Lt, float gap_open, float gap_extend, void* scratch,
                            void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (K <= 0 || Lq < 0 || Lt < 0 || (Lq > kStrip && Lt > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  sw_kernel<<<B, kWarp, 0, (cudaStream_t)stream>>>(
      (const int8_t*)queries, (const int32_t*)q_lens, (const int8_t*)targets,
      (const int32_t*)t_lens, (const float*)sub, K, B, Lq, Lt, gap_open, gap_extend,
      (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}
