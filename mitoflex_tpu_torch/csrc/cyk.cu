// Banded CYK over a covariance model's states for Hopper (sm_90a).
//
// Replaces the XLA lax.scan of mitoflex_tpu/ops/cyk_device.py
// cyk_banded_device (:323; the scan :172 over step :74). In the port its
// plain version is mitoflex_tpu_torch/ops/cyk_device.py cyk_banded_plain, a
// Python loop of about 18 eager tensor operations a state. Here one launch
// runs the whole DP of one call.
//
// The DP (NEG = -1e30; W = 2 slack + 2; a state's block is W x W, row r the
// span start o_i[v] + r, column c the span end o_j[v] + c):
// - E states: 0 where the span is empty and inside the window, else NEG.
// - A regular state: the max over its children c of the child's block read
//   at the offset (o_i[v] + si - o_i[c], o_j[v] - sj - o_j[c]) plus the
//   transition (NEG outside the child's block); in local mode the EL
//   pseudo-child, (c - r + o_j - sj - o_i - si) * el_selfsc + end_sc where
//   that span is >= 0 and its end inside the window; plus the emission (a
//   single score by row for ML/IL, by column for MR/IR, the pair table by
//   both codes for MP); IL self-loops as the reverse cummax over rows of
//   blk + g minus g, g the exclusive prefix sums of the clipped steps, and
//   IR self-loops as the forward cummax over columns of blk - G plus G, G
//   the inclusive ones.
// - A B state: max_k left[r, k] + right[k, m], the children's blocks
//   aligned to the parent's bands (the max-plus product, W^3 sums).
// - Then every state: NEG where the span is invalid (end before start, or
//   past the window), every value clamped at NEG from below.
// Each state's block goes to the deck [S, W, W]; its maximum and its first
// flat argmax (the lowest r * W + c among equals) to the outputs.
//
// Rounding: every sum and product is rounded as one float32 operation
// (__fadd_rn / __fmul_rn; nothing may contract into an FMA), in the plain
// version's order. The prefix sums are summed left to right in float64,
// each rounded to float32, which is what torch.cumsum does on the CPU. Max
// and compare are exact. So the kernel's maxima equal the CPU plain
// version's bit for bit; the plain version on a card sums its prefixes in
// another order (the last bits of its IL / IR states may differ).
//
// What bounds it on the H100: neither bytes nor operations but the chain
// of states: each state reads the blocks its children wrote, so states run
// one after another on one SM. The bytes the call must move are its inputs,
// its outputs and every block written once, 4 W^2 S (0.035 and 0.040 ms at
// 3.35 TB/s for the golden run's calls, 3024 and 3504 states at W 98); a
// state's children are its near neighbours in the scan order, so their
// blocks are read back from the L2 (the deck, 135 MB at the golden size,
// does not fit it, but the recent blocks do) and are not counted. The
// operations, mostly the bifurcations' W^3 sums, take less at 67 TFLOP/s. A
// state costs one SM's instruction issue for its W^2 cells, a few barriers
// and round trips to the L2: about 13 us a state on an H100 80GB HBM3 at
// 700 W (39 and 45 ms for those calls, chip_smoke.py phase 15), so the
// bound is about 0.09% of the kernel's time.
//
// Design (a simple one that is right; making it fast is later work):
// - one thread block of kThreads threads a call walks the E states, then
//   the scanned states in the order of the step table (decreasing state
//   index, so that every child is written before its parent reads it;
//   __syncthreads() makes the deck's writes visible inside the block);
// - thread (r0, c) of the block owns column c of rows r0, r0 + 8, ...
//   (kMaxW = 128 columns, 8 rows at a time; columns at or past W idle), so
//   that each child's column offset and row range are worked out once a
//   state and a cell costs a compare, a load, an add and a max a child;
// - a regular state's cells read the children from the deck; the
//   emissions' scores or codes sit in shared memory first; a state with a
//   self-loop keeps its block in shared memory, one thread sums the
//   prefixes, and one thread a column (IL) or a row (IR) runs the cummax;
// - a B state loads both aligned child blocks into shared memory and each
//   thread takes its cells' W-term max-plus sums from there;
// - each thread keeps the best of its cells (greater value, or equal value
//   at a lower index), and a block reduction gives the state's maximum and
//   first argmax;
// - dynamic shared memory: the block and the two B operands (3 W^2
//   float32) plus five W-vectors, 199,168 bytes at the largest W, kMaxW =
//   128 (the opt-in limit is 232,448); every caller uses W = 98 or less.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kDead = -3.0e4f;  // clipped self-loop step for invalid residues
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 128;
constexpr int kRowStep = kThreads / kMaxW;  // rows a column's threads stride by
constexpr int kMaxKids = 6;
// the step table's row (ops/cyk_device.py STEP_WORDS and the _W_* offsets)
constexpr int kStepWords = 20;
constexpr int kWV = 0, kWKind = 1, kWNKids = 2, kWLeft = 3, kWRight = 4, kWKid = 5,
              kWT = 11, kWSelf = 17, kWEnd = 18, kWFlags = 19;
constexpr int kHasSelf = 1, kHasEnd = 2;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void take_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The block's maximum of (bv, bi) with the lowest index among equals, to
// out_m[v] and out_a[v]; every thread of the block calls it. Ends in a
// barrier, so the caller may reuse shared memory right after.
__device__ void reduce_first_max(float bv, int bi, float* red_v, int* red_i, float* out_m,
                                 int* out_a, int v) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    take_better(bv, bi, __shfl_down_sync(all, bv, off), __shfl_down_sync(all, bi, off));
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? red_v[lane] : neg_inf();
    bi = lane < kWarps ? red_i[lane] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1)
      take_better(bv, bi, __shfl_down_sync(all, bv, off), __shfl_down_sync(all, bi, off));
    if (lane == 0) {
      out_m[v] = bv;
      out_a[v] = bi;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
cyk_kernel(const int32_t* __restrict__ steps, int n_scan, const int32_t* __restrict__ e_states,
           int n_e, const float* __restrict__ single5, const float* __restrict__ pair5,
           const int32_t* __restrict__ geo, int S, int L, int W, float el_selfsc,
           float* deck, float* out_m, int* out_a) {
  extern __shared__ float smem[];
  const int WW = W * W;
  float* blk = smem;          // W^2: a self-loop state's block
  float* lb = blk + WW;       // W^2: a B state's left operand
  float* rb = lb + WW;        // W^2: its right operand
  float* rowv = rb + WW;      // W: row emissions
  float* colv = rowv + W;     // W: column emissions
  float* pre = colv + W;      // W: prefix sums
  int* rowc = reinterpret_cast<int*>(pre + W);  // W: row codes (MP)
  int* colc = rowc + W;       // W: column codes (MP)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int tid = threadIdx.x;
  // thread (r0, c): column c of rows r0, r0 + kRowStep, ...; columns at or
  // past W idle
  const int c = tid % kMaxW, r0 = tid / kMaxW;
  const bool col_on = c < W;
  const int32_t* o_i = geo;
  const int32_t* o_j = geo + S;
  const int32_t* codes = geo + 2 * S;  // L + W + 2 codes: one pad, the window, pads

  // E states
  for (int e = 0; e < n_e; ++e) {
    const int v = e_states[e];
    const int oiv = o_i[v], ojv = o_j[v];
    float* dst = deck + (int64_t)v * WW;
    float bv = neg_inf();
    int bi = 0x7fffffff;
    if (col_on) {
      for (int r = r0; r < W; r += kRowStep) {
        const float x = (oiv + r == ojv + c && ojv + c <= L) ? 0.0f : kNeg;
        dst[r * W + c] = x;
        take_better(bv, bi, x, r * W + c);
      }
    }
    reduce_first_max(bv, bi, red_v, red_i, out_m, out_a, v);
  }

  for (int t = 0; t < n_scan; ++t) {
    const int32_t* row = steps + (int64_t)t * kStepWords;
    const int v = row[kWV], kind = row[kWKind];
    const int oiv = o_i[v], ojv = o_j[v];
    float* dst = deck + (int64_t)v * WW;
    float bv = neg_inf();
    int bi = 0x7fffffff;
    // the span validity of this thread's cells: j >= i, i and j inside the window
    const int r_end = min(W, L - oiv + 1);
    const bool c_in = col_on && c < L - ojv + 1;
    const int diag = c - (oiv - ojv);  // valid rows: r <= diag

    if (kind < 0) {
      // bifurcation: the two children's blocks aligned to this state's bands
      const int lch = row[kWLeft], rch = row[kWRight];
      const int ldi = oiv - o_i[lch];
      const int rdi = o_j[lch] - o_i[rch], rdj = ojv - o_j[rch];
      const float* lsrc = deck + (int64_t)lch * WW;
      const float* rsrc = deck + (int64_t)rch * WW;
      if (col_on) {
        const bool rc_ok = c + rdj >= 0 && c + rdj < W;
        for (int r = r0; r < W; r += kRowStep) {
          const int lr = r + ldi, rr = r + rdi;
          lb[r * W + c] = (lr >= 0 && lr < W) ? lsrc[lr * W + c] : kNeg;
          rb[r * W + c] = (rc_ok && rr >= 0 && rr < W) ? rsrc[rr * W + c + rdj] : kNeg;
        }
      }
      __syncthreads();
      if (col_on) {
        for (int r = r0; r < W; r += kRowStep) {
          const float* lrow = lb + r * W;
          float x = neg_inf();
          for (int k = 0; k < W; ++k) x = fmaxf(x, __fadd_rn(lrow[k], rb[k * W + c]));
          x = (c_in && r < r_end && r <= diag) ? fmaxf(x, kNeg) : kNeg;
          dst[r * W + c] = x;
          take_better(bv, bi, x, r * W + c);
        }
      }
      reduce_first_max(bv, bi, red_v, red_i, out_m, out_a, v);
      continue;
    }

    const int nk = row[kWNKids], flags = row[kWFlags];
    const float self_t = __int_as_float(row[kWSelf]);
    const float end_sc = __int_as_float(row[kWEnd]);
    const bool il = kind == 1 && (flags & kHasSelf);
    const bool ir = kind == 2 && (flags & kHasSelf);
    const int si = (kind == 1 || kind == 3) ? 1 : 0;
    const int sj = (kind == 2 || kind == 3) ? 1 : 0;
    // emissions along the band: row r is residue o_i + r (code at o_i + 1 +
    // r of the padded window), column c residue o_j + c - 1 (code at o_j + c)
    if (tid < W) {
      const int ci = codes[oiv + 1 + tid], cj = codes[ojv + tid];
      if (kind == 1) rowv[tid] = single5[v * 5 + ci];
      if (kind == 2) colv[tid] = single5[v * 5 + cj];
      if (kind == 3) {
        rowc[tid] = ci;
        colc[tid] = cj;
      }
    }
    __syncthreads();
    if ((il || ir) && tid == kThreads - 1) {
      // IL: g[r] = d[0] + ... + d[r - 1]; IR: G[c] = d[0] + ... + d[c];
      // d the step (emission + self-loop) clipped at kDead
      const float* em = il ? rowv : colv;
      double acc = 0.0;
      for (int k = 0; k < W; ++k) {
        const float d = fmaxf(__fadd_rn(em[k], self_t), kDead);
        if (il) {
          pre[k] = (float)acc;
          acc += (double)d;
        } else {
          acc += (double)d;
          pre[k] = (float)acc;
        }
      }
    }
    if (col_on) {
      // child k read at rows [rlo, rhi) of this column, through src + r * W
      const float* src[kMaxKids];
      int rlo[kMaxKids], rhi[kMaxKids];
      float kt[kMaxKids];
#pragma unroll
      for (int k = 0; k < kMaxKids; ++k) {
        rlo[k] = W;
        rhi[k] = 0;
        if (k < nk) {
          const int kid = row[kWKid + k];
          const int di = oiv + si - o_i[kid], dj = ojv - sj - o_j[kid];
          kt[k] = __int_as_float(row[kWT + k]);
          src[k] = deck + (int64_t)kid * WW + di * W + c + dj;
          if (c + dj >= 0 && c + dj < W) {
            rlo[k] = max(0, -di);
            rhi[k] = min(W, W - di);
          }
        }
      }
      const bool has_end = (flags & kHasEnd) != 0;
      const int span0 = c + ojv - sj - oiv - si;  // the EL span at row 0
      const bool el_col = c < L - (ojv - sj) + 1;  // EL's end inside the window
      const float col_em = kind == 2 ? colv[c] : 0.0f;
      const int col_code = kind == 3 ? colc[c] : 0;
      for (int r = r0; r < W; r += kRowStep) {
        float x = kNeg;
#pragma unroll
        for (int k = 0; k < kMaxKids; ++k)
          if (r >= rlo[k] && r < rhi[k]) x = fmaxf(x, __fadd_rn(src[k][r * W], kt[k]));
        if (has_end) {
          const int span = span0 - r;
          const float el = (span >= 0 && el_col) ? __fmul_rn((float)span, el_selfsc) : kNeg;
          x = fmaxf(x, __fadd_rn(el, end_sc));
        }
        if (kind == 1) x = __fadd_rn(x, rowv[r]);
        else if (kind == 2) x = __fadd_rn(x, col_em);
        else if (kind == 3) x = __fadd_rn(x, pair5[v * 25 + rowc[r] * 5 + col_code]);
        if (il || ir) {
          blk[r * W + c] = x;
        } else {
          x = (c_in && r < r_end && r <= diag) ? fmaxf(x, kNeg) : kNeg;
          dst[r * W + c] = x;
          take_better(bv, bi, x, r * W + c);
        }
      }
    }
    if (il || ir) {
      __syncthreads();
      if (tid < W) {
        if (il) {
          // column tid, rows from the bottom: max_{k >= r}(blk[k] + g[k]) - g[r]
          float run = neg_inf();
          for (int r = W - 1; r >= 0; --r) {
            run = fmaxf(run, __fadd_rn(blk[r * W + tid], pre[r]));
            blk[r * W + tid] = __fsub_rn(run, pre[r]);
          }
        } else {
          // row tid, columns from the left: max_{k <= c}(blk[k] - G[k]) + G[c]
          float run = neg_inf();
          for (int k = 0; k < W; ++k) {
            run = fmaxf(run, __fsub_rn(blk[tid * W + k], pre[k]));
            blk[tid * W + k] = __fadd_rn(run, pre[k]);
          }
        }
      }
      __syncthreads();
      if (col_on) {
        for (int r = r0; r < W; r += kRowStep) {
          const float x = (c_in && r < r_end && r <= diag) ? fmaxf(blk[r * W + c], kNeg) : kNeg;
          dst[r * W + c] = x;
          take_better(bv, bi, x, r * W + c);
        }
      }
    }
    reduce_first_max(bv, bi, red_v, red_i, out_m, out_a, v);
  }
}

size_t smem_bytes(int W) {
  return (size_t)(3 * W * W + 3 * W) * sizeof(float) + (size_t)2 * W * sizeof(int);
}

}  // namespace

// One banded CYK. steps: [n_scan, 20] int32 step table (scores as float32
// bits); e_states: [n_e] int32; single5 [S, 5] and pair5 [S, 25] float32
// (column 4 / code 4: an invalid residue); geo: [2 S + L + W + 2] int32, the
// band origins o_i and o_j then the padded window's codes; deck: [S, W, W]
// float32 scratch (every block is written); out: [2, S] int32, each state's
// block maximum (float32 bits) then its first argmax cell r * W + c.
extern "C" int mfx_cyk_banded(const void* steps, int n_scan, const void* e_states, int n_e,
                              const void* single5, const void* pair5, const void* geo, int S,
                              int L, int W, float el_selfsc, void* deck, void* out,
                              void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (W < 2 || W > kMaxW || L < 0 || n_scan < 0 || n_e < 0 || n_scan + n_e > S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W);
  cudaError_t err =
      cudaFuncSetAttribute(cyk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int32_t* o = (int32_t*)out;
  cyk_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)steps, n_scan, (const int32_t*)e_states, n_e, (const float*)single5,
      (const float*)pair5, (const int32_t*)geo, S, L, W, el_selfsc, (float*)deck,
      (float*)o, o + S);
  return (int)cudaGetLastError();
}
