// Profile-HMM local Viterbi scans for Hopper (sm_90a): nhmmer's two passes.
//
// Replaces the XLA lax.scans of mitoflex_tpu/ops/phmm.py: viterbi_scores_multi
// (:351, the pass-1 sweep of every stacked model over every window, scores
// only; viterbi_scores :276 is its one-model case) and viterbi_scan (:139,
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
// version's, in its order (adds and compares only: nothing to contract into
// an FMA), so the scores are bit-equal and every coordinate exact.
//
// What bounds it on the H100: float32 ALU work, M * B * T * L cells at
// 15 + log2(W) operations a cell (scores pass; the scan pass adds about 30
// integer selects for the envelope payloads) over 67 TFLOP/s outside the
// tensor cores; the profile and windows are a few MB, so device memory is
// no limit. The work is also serial in t: a row's T steps follow one
// another, each a handful of dependent operations and two block barriers.
//
// Design (a simple one that is right; making it fast is later work):
// - one block a (model, window) row, up to 512 threads; thread i owns K
//   consecutive columns (K = 1 up to Lp 512, then 2, 4, 8, 16), with their
//   transitions and M, I, D (and the payloads) in registers. The many rows
//   of a batch (M * B blocks) hide each row's serial chain.
// - per step: a phase that computes M and I from the left neighbour's
//   previous state (own registers, or the previous thread's last column
//   through shared memory) and writes a = M + tMD - cdd (and M's payloads)
//   to shared memory; a barrier; a phase that closes the delete chain by
//   reading the W columns left of each own column from shared memory,
//   updates the per-column best, and posts the last column's state for the
//   next step's neighbour; a barrier. The exact closure runs Hillis-Steele
//   rounds (leftmost on ties) in shared memory, a barrier a round.
// - the window code of the next step and its emission scores are fetched
//   one step ahead, so their latency overlaps the step.
// - columns at or past the model length never feed a column inside it (all
//   dependences run from j-1 and left), so they are skipped; the plain
//   version's per-column best there stays NEG and never wins the first-max.
// - a row stops at its length: past it every emission is NEG, so every new
//   M is NEG + (a score of at most thousands of bits), which rounds to NEG
//   or below, and neither the best score nor any payload can change.
// - the final pick (the first column of the per-column best maximum, its
//   payloads) is a block reduction in the same launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

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
  const float* entry;        // [Mn]
  const int32_t* model_lens;  // [Mn] (scores pass) or null
  int model_len;              // scan pass
  const int8_t* seqs;         // [B, T]
  const int32_t* lengths;     // [B]
  int B, T, Lp;
  int window;  // W of the banded closure; 0: exact (scan pass only)
  float* out_score;  // scores pass: [Mn, B]; scan pass: [B]
  int32_t* out_from;
  int32_t* out_to;
  int32_t* out_hmm_from;
  int32_t* out_hmm_to;
};

// shared memory: a, M's payloads, the posted neighbour state, the exact
// closure's ping-pong buffers, the reduction scratch
struct Smem {
  float* a;
  int* ts;
  int* js;
  float* bM;
  float* bI;
  float* bD;
  int* bP;  // 6 payload words a thread: M_ts M_js I_ts I_js D_ts D_js
  float* xv;  // exact closure: second value buffer
  int* xi0;   // and the two index buffers
  int* xi1;
};

__host__ __device__ inline size_t smem_bytes(int NT, int K, bool scan, bool exact) {
  const size_t LpPad = (size_t)NT * K;
  size_t n = LpPad * 4 + (size_t)NT * 12;
  if (scan) n += LpPad * 8 + (size_t)NT * 24;
  if (exact) n += LpPad * 12;
  return n;
}

template <int K, bool SCAN>
__global__ void __launch_bounds__(kMaxThreads)
viterbi_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int LpPad = NT * K;
  const int b = blockIdx.x;
  const int m = blockIdx.y;
  const int Lp = p.Lp;
  const bool exact = SCAN && p.window <= 0;

  Smem s;
  {
    unsigned char* q = smem_raw;
    s.a = (float*)q; q += LpPad * 4;
    s.bM = (float*)q; q += NT * 4;
    s.bI = (float*)q; q += NT * 4;
    s.bD = (float*)q; q += NT * 4;
    s.ts = s.js = s.bP = nullptr;
    s.xv = nullptr;
    s.xi0 = s.xi1 = nullptr;
    if (SCAN) {
      s.ts = (int*)q; q += LpPad * 4;
      s.js = (int*)q; q += LpPad * 4;
      s.bP = (int*)q; q += NT * 24;
    }
    if (exact) {
      s.xv = (float*)q; q += LpPad * 4;
      s.xi0 = (int*)q; q += LpPad * 4;
      s.xi1 = (int*)q; q += LpPad * 4;
    }
  }

  const int ml = SCAN ? p.model_len : p.model_lens[m];
  const int n = ml < Lp ? ml : Lp;  // columns inside the model
  const int T = p.T;
  const int len = p.lengths[b];
  const int t_end = len < T ? (len > 0 ? len : 0) : T;
  const int8_t* row = p.seqs + (int64_t)b * T;
  const int64_t moff = (int64_t)m * Lp;
  const float* msc = p.msc + moff * 4;
  const float* isc = p.isc + moff * 4;
  const float entry = p.entry[m];
  const int j0 = tid * K;
  const bool active = j0 < n;

  float tmm[K], tim[K], tdm[K], tmi[K], tii[K], tmd[K], cdd[K], cddp[K];
  float M[K], I[K], D[K];
  int Mts[K], Mjs[K], Its[K], Ijs[K], Dts[K], Djs[K];
  float bV[K];
  int bVts[K], bVjs[K], bVt[K];
  float em[K], ei[K];  // emissions of the step about to run
  float best = kNeg;   // scores pass: the row's best M so far
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    const bool in = j < n;
    tmm[k] = in ? p.tmm[moff + j] : kNeg;
    tim[k] = in ? p.tim[moff + j] : kNeg;
    tdm[k] = in ? p.tdm[moff + j] : kNeg;
    tmi[k] = in ? p.tmi[moff + j] : kNeg;
    tii[k] = in ? p.tii[moff + j] : kNeg;
    tmd[k] = in ? p.tmd[moff + j] : kNeg;
    cdd[k] = in ? p.cdd[moff + j] : kNeg;
    cddp[k] = (in && j > 0) ? p.cdd[moff + j - 1] : 0.0f;
    M[k] = I[k] = D[k] = kNeg;
    Mts[k] = Mjs[k] = Its[k] = Ijs[k] = Dts[k] = Djs[k] = 0;
    bV[k] = kNeg;
    bVts[k] = bVjs[k] = bVt[k] = 0;
    em[k] = ei[k] = kNeg;
  }
  s.bM[tid] = kNeg;
  s.bI[tid] = kNeg;
  s.bD[tid] = kNeg;
  if (SCAN) {
#pragma unroll
    for (int w = 0; w < 6; ++w) s.bP[tid * 6 + w] = 0;
  }
  // the first step's code and emissions
  int x = t_end > 0 ? (int)row[0] : 4;
  if (active && x < 4) {
    const int c = x < 0 ? 0 : x;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + k < n) {
        em[k] = __ldg(msc + (j0 + k) * 4 + c);
        ei[k] = __ldg(isc + (j0 + k) * 4 + c);
      }
    }
  }
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    // ---- phase 1: M and I from the previous step's state
    if (active) {
      float lM = kNeg, lI = kNeg, lD = kNeg;
      int lMts = 0, lMjs = 0, lIts = 0, lIjs = 0, lDts = 0, lDjs = 0;
      if (tid > 0) {
        lM = s.bM[tid - 1];
        lI = s.bI[tid - 1];
        lD = s.bD[tid - 1];
        if (SCAN) {
          const int* q = s.bP + (tid - 1) * 6;
          lMts = q[0]; lMjs = q[1]; lIts = q[2]; lIjs = q[3]; lDts = q[4]; lDjs = q[5];
        }
      }
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const int j = j0 + k;
        if (j < n) {
          const float pM = k ? M[k - 1] : lM;
          const float pI = k ? I[k - 1] : lI;
          const float pD = k ? D[k - 1] : lD;
          float bst;
          int ts = 0, js = 0;
          if (SCAN) {
            const int pMts = k ? Mts[k - 1] : lMts, pMjs = k ? Mjs[k - 1] : lMjs;
            const int pIts = k ? Its[k - 1] : lIts, pIjs = k ? Ijs[k - 1] : lIjs;
            const int pDts = k ? Dts[k - 1] : lDts, pDjs = k ? Djs[k - 1] : lDjs;
            bst = entry;
            ts = t;
            js = j + 1;
            float v = pM + tmm[k];
            if (v > bst) { bst = v; ts = pMts; js = pMjs; }
            v = pI + tim[k];
            if (v > bst) { bst = v; ts = pIts; js = pIjs; }
            v = pD + tdm[k];
            if (v > bst) { bst = v; ts = pDts; js = pDjs; }
            const float ivm = M[k] + tmi[k];
            const float ivi = I[k] + tii[k];
            const bool take_m = ivm >= ivi;
            Its[k] = take_m ? Mts[k] : Its[k];
            Ijs[k] = take_m ? Mjs[k] : Ijs[k];
            I[k] = ei[k] + (take_m ? ivm : ivi);
          } else {
            bst = fmaxf(fmaxf(entry, pM + tmm[k]), fmaxf(pI + tim[k], pD + tdm[k]));
            I[k] = ei[k] + fmaxf(M[k] + tmi[k], I[k] + tii[k]);
          }
          M[k] = em[k] + bst;
          Mts[k] = ts;
          Mjs[k] = js;
          s.a[j] = (M[k] + tmd[k]) - cdd[k];
          if (SCAN) {
            s.ts[j] = ts;
            s.js[j] = js;
            if (exact) s.xi0[j] = j;
          }
        }
      }
    }
    // the next step's code and emissions, fetched while this one finishes
    const int xn = t + 1 < t_end ? (int)row[t + 1] : 4;
    float emn[K], ein[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      emn[k] = kNeg;
      ein[k] = kNeg;
    }
    if (active && xn < 4) {
      const int c = xn < 0 ? 0 : xn;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (j0 + k < n) {
          emn[k] = __ldg(msc + (j0 + k) * 4 + c);
          ein[k] = __ldg(isc + (j0 + k) * 4 + c);
        }
      }
    }
    __syncthreads();

    // ---- phase 2: the delete closure, D, the per-column best
    const float* cv = s.a;  // closure values and indices (exact: after the rounds)
    const int* ci = s.xi0;
    if (exact) {
      // Hillis-Steele over the model's columns; the left operand wins ties
      float* vb[2] = {s.a, s.xv};
      int* ib[2] = {s.xi0, s.xi1};
      int src = 0;
      for (int sh = 1; sh < n; sh <<= 1) {
        if (active) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int j = j0 + k;
            if (j < n) {
              float v = vb[src][j];
              int i = ib[src][j];
              if (j >= sh) {
                const float lv = vb[src][j - sh];
                if (lv >= v) { v = lv; i = ib[src][j - sh]; }
              }
              vb[src ^ 1][j] = v;
              ib[src ^ 1][j] = i;
            }
          }
        }
        __syncthreads();
        src ^= 1;
      }
      cv = vb[src];
      ci = ib[src];
    }
    if (active) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        if (j < n) {
          // cm[j-1]: (value, column); column -1 is the fill (NEG, payload 0)
          float c = kNeg;
          int at = -1;
          if (exact) {
            if (j > 0) { c = cv[j - 1]; at = ci[j - 1]; }
          } else {
            int lo = j - p.window;
            if (lo >= 0) { c = cv[lo]; at = lo; ++lo; } else { lo = 0; }
            if (SCAN) {
              for (int i = lo; i < j; ++i) {
                const float v = cv[i];
                if (v >= c) { c = v; at = i; }
              }
            } else {
              for (int i = lo; i < j; ++i) c = fmaxf(c, cv[i]);
            }
          }
          D[k] = c + cddp[k];
          if (SCAN) {
            Dts[k] = at < 0 ? 0 : s.ts[at];
            Djs[k] = at < 0 ? 0 : s.js[at];
            if (M[k] > bV[k]) {
              bV[k] = M[k];
              bVts[k] = Mts[k];
              bVjs[k] = Mjs[k];
              bVt[k] = t;
            }
          } else {
            best = fmaxf(best, M[k]);
          }
        }
      }
      s.bM[tid] = M[K - 1];
      s.bI[tid] = I[K - 1];
      s.bD[tid] = D[K - 1];
      if (SCAN) {
        int* q = s.bP + tid * 6;
        q[0] = Mts[K - 1]; q[1] = Mjs[K - 1]; q[2] = Its[K - 1];
        q[3] = Ijs[K - 1]; q[4] = Dts[K - 1]; q[5] = Djs[K - 1];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      em[k] = emn[k];
      ei[k] = ein[k];
    }
    __syncthreads();
  }

  // ---- the final pick
  __shared__ float rv[kMaxWarps];
  __shared__ int rc[kMaxWarps], rts[kMaxWarps], rjs[kMaxWarps], rt[kMaxWarps];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = NT >> 5;
  if (!SCAN) {
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_down_sync(0xffffffffu, best, off));
    if (lane == 0) rv[warp] = best;
    __syncthreads();
    if (tid == 0) {
      float v = rv[0];
      for (int w = 1; w < nwarps; ++w) v = fmaxf(v, rv[w]);
      p.out_score[(int64_t)m * p.B + b] = v;
    }
    return;
  }
  // the first column of the maximum; every thread starts from column 0 at
  // NEG with zero payloads, which is column 0's own state whenever its best
  // is still NEG
  float v = kNeg;
  int col = 0, vts = 0, vjs = 0, vt = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (j0 + k < n && bV[k] > v) {
      v = bV[k]; col = j0 + k; vts = bVts[k]; vjs = bVjs[k]; vt = bVt[k];
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oc = __shfl_down_sync(0xffffffffu, col, off);
    const int ots = __shfl_down_sync(0xffffffffu, vts, off);
    const int ojs = __shfl_down_sync(0xffffffffu, vjs, off);
    const int ot = __shfl_down_sync(0xffffffffu, vt, off);
    if (ov > v || (ov == v && oc < col)) {
      v = ov; col = oc; vts = ots; vjs = ojs; vt = ot;
    }
  }
  if (lane == 0) {
    rv[warp] = v; rc[warp] = col; rts[warp] = vts; rjs[warp] = vjs; rt[warp] = vt;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w) {
      if (rv[w] > v || (rv[w] == v && rc[w] < col)) {
        v = rv[w]; col = rc[w]; vts = rts[w]; vjs = rjs[w]; vt = rt[w];
      }
    }
    p.out_score[b] = v;
    p.out_from[b] = vts;
    p.out_to[b] = vt;
    p.out_hmm_from[b] = vjs;
    p.out_hmm_to[b] = col + 1;
  }
}

// columns a thread: the least power of two that keeps a block at 512
// threads (0 past Lp 8192)
int columns_per_thread(int Lp) {
  for (int K = 1; K <= 16; K <<= 1)
    if ((Lp + K - 1) / K <= kMaxThreads) return K;
  return 0;
}

template <bool SCAN>
int launch(const Args& a, int Mn, cudaStream_t stream) {
  const int K = columns_per_thread(a.Lp);
  if (K == 0 || a.Lp <= 0) return (int)cudaErrorInvalidValue;
  const int NT = ((a.Lp + K - 1) / K + 31) / 32 * 32;
  const bool exact = SCAN && a.window <= 0;
  const size_t smem = smem_bytes(NT, K, SCAN, exact);
  const dim3 grid((unsigned)a.B, (unsigned)Mn);
  void (*kern)(Args) = nullptr;
  switch (K) {
    case 1: kern = viterbi_kernel<1, SCAN>; break;
    case 2: kern = viterbi_kernel<2, SCAN>; break;
    case 4: kern = viterbi_kernel<4, SCAN>; break;
    case 8: kern = viterbi_kernel<8, SCAN>; break;
    default: kern = viterbi_kernel<16, SCAN>; break;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1: out[Mn, B] best scores of every stacked model on every window.
// Profile arrays are [Mn, Lp, 4] (msc, isc) and [Mn, Lp] (transitions,
// cdd), entry and model_lens [Mn]; seqs [B, T] int8, lengths [B] int32.
// window: the closure's width, the least power of two >= max(band, 2).
extern "C" int mfx_viterbi_scores(
    const void* msc, const void* isc, const void* tmm, const void* tim,
    const void* tdm, const void* tmi, const void* tii, const void* tmd,
    const void* cdd, const void* entry, const void* model_lens, int Mn,
    const void* seqs, const void* lengths, int B, int T, int Lp, int window,
    void* out, void* stream) {
  if (Mn <= 0 || B <= 0) return (int)cudaSuccess;
  Args a = {};
  a.msc = (const float*)msc; a.isc = (const float*)isc;
  a.tmm = (const float*)tmm; a.tim = (const float*)tim; a.tdm = (const float*)tdm;
  a.tmi = (const float*)tmi; a.tii = (const float*)tii; a.tmd = (const float*)tmd;
  a.cdd = (const float*)cdd; a.entry = (const float*)entry;
  a.model_lens = (const int32_t*)model_lens;
  a.seqs = (const int8_t*)seqs; a.lengths = (const int32_t*)lengths;
  a.B = B; a.T = T; a.Lp = Lp; a.window = window < 1 ? 1 : window;
  a.out_score = (float*)out;
  return launch<false>(a, Mn, (cudaStream_t)stream);
}

// Pass 2: the best local score of one model on each window and its
// envelope; out: [5, B] int32 words (score as float32 bits, seq_from,
// seq_to, hmm_from, hmm_to). window: the least power of two >= band; 0 for
// the exact closure.
extern "C" int mfx_viterbi_scan(
    const void* msc, const void* isc, const void* tmm, const void* tim,
    const void* tdm, const void* tmi, const void* tii, const void* tmd,
    const void* cdd, const void* entry, int model_len, const void* seqs,
    const void* lengths, int B, int T, int Lp, int window, void* out,
    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  Args a = {};
  a.msc = (const float*)msc; a.isc = (const float*)isc;
  a.tmm = (const float*)tmm; a.tim = (const float*)tim; a.tdm = (const float*)tdm;
  a.tmi = (const float*)tmi; a.tii = (const float*)tii; a.tmd = (const float*)tmd;
  a.cdd = (const float*)cdd; a.entry = (const float*)entry;
  a.model_len = model_len;
  a.seqs = (const int8_t*)seqs; a.lengths = (const int32_t*)lengths;
  a.B = B; a.T = T; a.Lp = Lp; a.window = window < 0 ? 0 : window;
  int32_t* o = (int32_t*)out;
  a.out_score = (float*)o;
  a.out_from = o + B;
  a.out_to = o + 2 * (int64_t)B;
  a.out_hmm_from = o + 3 * (int64_t)B;
  a.out_hmm_to = o + 4 * (int64_t)B;
  return launch<true>(a, 1, (cudaStream_t)stream);
}
