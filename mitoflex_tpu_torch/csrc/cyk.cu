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
// and compare are exact, so the order in which maxima are taken (of the
// children, of the max-plus terms, along a cummax) changes no bit. So the
// kernel's maxima equal the CPU plain version's bit for bit; the plain
// version on a card sums its prefixes in another order (the last bits of
// its IL / IR states may differ).
//
// What bounds it on the H100: neither bytes nor operations but the chain
// of states. The bytes the call must move are its inputs, its outputs and
// every block written once, 4 W^2 S (0.035 and 0.040 ms at 3.35 TB/s for
// the golden run's calls, 3024 and 3504 states at W 98); a child block is
// read back from the L2 soon after it is written and is not counted. The
// operations, mostly the bifurcations' W^3 sums, take less at 67 TFLOP/s.
// A state needs only its children's blocks, so the states of one level (0
// for E, else 1 more than the children's highest) are independent, and a
// call cannot take less than its longest chain of children, the schedule's
// depth (417 and 400 states on the golden run's models, 362 and 378 on
// scripts/torch_kernel_bench.py's models of its shapes: about a tenth of
// their states), at one state's time each. One block walking
// every state in turn (this kernel's first design) took about 13 us a
// state, 39 and 45 ms a golden call; here a state on the chain takes about
// 4.5 us (a B state about 18 us), about 2.1 ms a call (2.4 ms with the
// wrapper's host work).
//
// Design: a dataflow over the states, one launch a call.
// - One block of kThreads threads on each SM (min(SMs, states) blocks, an
//   ordinary launch). A block takes the next state from a global work
//   counter, in dispatch order: the E states, then the step table's rows
//   in the order ops/cyk_device.py _schedule gives (level by level, every
//   child before its parent).
// - A block first reads what no other state writes (the step row, the
//   origins, the emissions, the self-loop's prefix sums), then waits until
//   each child's ready flag holds this call's epoch (one thread a child
//   spins with ld.acquire.gpu), computes the state, and publishes its flag
//   (a barrier, then st.release.gpu from one thread) before it reduces the
//   block to its maximum, which no other state reads. Deck reads go through the L2 (bulk copies, ld.global.cg): the
//   L1 of one SM does not see another SM's writes. A flag not ready after
//   kMaxPolls polls traps.
// - No deadlock, whether or not every block is resident: blocks take
//   states strictly in dispatch order and finish one before they take
//   another, so the earliest unfinished state always belongs to a running
//   block, and all of its children are done.
// - The wrapper owns the scratch: the flags (zeroed once when made; each
//   call takes a larger epoch, so no call clears them) and the two
//   counters, which the last block to finish sets back to 0 for the next
//   call. The kernel allocates nothing. The launch's setup (the SM count,
//   the shared-memory limits, the kernel's dynamic shared-memory attribute)
//   is read and set once for each device and instantiation.
// - A regular state: the thread that sees a child's flag copies the
//   child's whole block into a shared-memory slot at once (cp.async.bulk,
//   completed on an mbarrier; as many slots as fit, six at W 98, so a
//   state's children come in one round), and thread (g, c) of the block
//   folds column c of its kRows rows from g kRows on in from there. The
//   kernel is built twice: for any W (kMaxRows rows a thread), and for
//   kRrnaW = 98, the rRNA refine's width at its slack of 48 (a test pins
//   the two together), with its 10 rows a thread and every row stride an
//   immediate.
// - A self-loop state: IL's cummax runs down each thread's rows in
//   registers, then takes the largest of the row groups below it from
//   shared memory; IR's goes through shared memory, one thread a run of
//   kRows cells of a row, then the largest of the runs left of it. One
//   thread sums the prefixes before the wait, as they depend on no other
//   state.
// - A B state loads both aligned child blocks into shared memory, the left
//   one transposed, at a pitch P = W rounded up to 4; each thread takes a
//   kTile x kTile tile of cells and reads a column of the left operand and
//   a row of the right one as float4s each step of the max-plus sum. (Four
//   blocks a B state, each a share of its rows, measured slower.)
// - Each thread keeps the best of its cells (greater value, or equal value
//   at a lower index), and a block reduction gives the state's maximum and
//   first argmax.
// - Dynamic shared memory: the slots (or the B operands, or a self-loop
//   state's block and partial maxima, where larger) and two W-vectors,
//   231,280 bytes at W 98 (six slots) and 197,632 at kMaxW = 128 (three),
//   within the 232,448 of the opt-in limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kDead = -3.0e4f;  // clipped self-loop step for invalid residues
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 128;
// rows a thread owns at most: (kThreads / W) * kMaxRows >= W for every W
// up to kMaxW
constexpr int kMaxRows = 16;
constexpr int kTile = 4;                    // a B state's cells a thread: kTile^2
constexpr int kTiles = kMaxW / kTile;       // tile rows (and columns) at kMaxW
constexpr int kMaxKids = 6;
// W at the slack of the rRNA refine (models/cmsearch.py _cyk_banded_refine,
// 48), which has its own instantiation with every stride an immediate
constexpr int kRrnaW = 98;
constexpr int kRrnaRows = (kRrnaW + kThreads / kRrnaW - 1) / (kThreads / kRrnaW);
// the step table's row (ops/cyk_device.py STEP_WORDS and the _W_* offsets)
constexpr int kStepWords = 20;
constexpr int kWV = 0, kWKind = 1, kWNKids = 2, kWLeft = 3, kWRight = 4, kWKid = 5,
              kWT = 11, kWSelf = 17, kWEnd = 18, kWFlags = 19;
constexpr int kHasSelf = 1, kHasEnd = 2;
constexpr int kKindE = 4;  // an E state (the step table's kinds are -1 to 3)
// a child still not ready after this many polls (seconds; a call takes
// milliseconds) is a fault of the schedule: the kernel traps, and the call
// fails instead of hanging the card
constexpr int kMaxPolls = 1 << 24;

static_assert(kTiles * kTiles == kThreads, "one B tile a thread at kMaxW");
static_assert((kThreads / kMaxW) * kMaxRows >= kMaxW, "rows a thread at kMaxW");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the child blocks' bulk copies (TMA) into shared memory, completed on an
// mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void take_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// The block's maximum of (bv, bi) with the lowest index among equals, to
// *out_m and *out_a (from thread 0); every thread of the block calls it.
// Ends in a barrier, so the caller may reuse shared memory right after.
__device__ void reduce_first_max(float bv, int bi, float* red_v, int* red_i, float* out_m,
                                 int* out_a) {
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
      *out_m = bv;
      *out_a = bi;
    }
  }
  __syncthreads();
}

// floats of the region that the slots, the B operands and a self-loop's
// block and partial maxima share
__host__ __device__ __forceinline__ int region_floats(int W, int nslots) {
  const int P = (W + 3) & ~3;
  const int a = nslots * W * W, b = 2 * P * P, c = W * W + kThreads;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// kRows: the rows a thread owns at most at this W, ceil(W / (kThreads / W));
// kW: the band width W when it is fixed at compile time (every row stride
// and offset an immediate), or 0 for the width w given at run time
template <int kRows, int kW>
__global__ void __launch_bounds__(kThreads, 1)
cyk_kernel(const int32_t* __restrict__ steps, int n_scan, const int32_t* __restrict__ order,
           const int32_t* __restrict__ e_states, int n_e, const float* __restrict__ single5,
           const float* __restrict__ pair5, const int32_t* __restrict__ geo, int S, int L,
           int w, float el_selfsc, float* deck, float* out_m, int* out_a, int* sync,
           int epoch, int nslots) {
  const int W = kW > 0 ? kW : w;
  extern __shared__ float4 smem4[];
  const int WW = W * W;
  const int P = (W + 3) & ~3;              // the B operands' pitch
  float* slots = reinterpret_cast<float*>(smem4);  // nslots W^2: child blocks
  float* lbt = slots;                      // P^2: B's left operand, transposed
  float* rbs = lbt + P * P;                // P^2: B's right operand
  float* blk = slots;                      // W^2: a self-loop state's block
  float* vec0 = slots + region_floats(W, nslots);
  float* vec1 = vec0 + W;
  float* rowv = vec0;                      // W: row emissions (ML, IL)
  float* colv = vec0;                      // W: column emissions (MR, IR)
  float* pre = vec1;                       // W: prefix sums (IL, IR)
  int* rowc = reinterpret_cast<int*>(vec0);  // W: row codes (MP)
  int* colc = reinterpret_cast<int*>(vec1);  // W: column codes (MP)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_item;
  __shared__ int s_row[kStepWords];
  __shared__ int s_kid[kMaxKids], s_di[kMaxKids], s_dj[kMaxKids];
  __shared__ float s_pair[25];
  __shared__ alignas(8) uint64_t s_bar;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned all = 0xffffffffu;
  // thread (g, c): column c of the kRows rows from r0 = g kRows on (rows
  // past W idle)
  const int c = tid % W, r0 = (tid / W) * kRows;
  const bool on = tid < kThreads / W * W && r0 < W;
  const int32_t* o_i = geo;
  const int32_t* o_j = geo + S;
  const int32_t* codes = geo + 2 * S;  // L + W + 2 codes: one pad, the window, pads
  int* work = sync;
  int* done = sync + 1;
  int* ready = sync + 2;
  const int n_items = n_e + n_scan;
  uint32_t phase = 0;  // the mbarrier's phase of the next bulk copies
  if (tid == 0) mbar_init(&s_bar);

  for (;;) {
    if (tid == 0) s_item = atomicAdd(work, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;

    // ---- what no other state writes: the step row, origins, emissions
    if (tid < kStepWords) {
      if (item < n_e)
        s_row[tid] = tid == kWV ? e_states[item] : tid == kWKind ? kKindE : 0;
      else
        s_row[tid] = steps[(int64_t)order[item - n_e] * kStepWords + tid];
    }
    __syncthreads();
    const int v = s_row[kWV], kind = s_row[kWKind], flags = s_row[kWFlags];
    const int oiv = o_i[v], ojv = o_j[v];
    const int si = (kind == 1 || kind == 3) ? 1 : 0;
    const int sj = (kind == 2 || kind == 3) ? 1 : 0;
    const bool il = kind == 1 && (flags & kHasSelf);
    const bool ir = kind == 2 && (flags & kHasSelf);
    const int ndeps = kind == kKindE ? 0 : kind < 0 ? 2 : s_row[kWNKids];
    if (tid < ndeps && kind >= 0) {
      const int kid = s_row[kWKid + tid];
      s_kid[tid] = kid;
      s_di[tid] = oiv + si - o_i[kid];
      s_dj[tid] = ojv - sj - o_j[kid];
    }
    // emissions along the band: row r is residue o_i + r (code at o_i + 1 +
    // r of the padded window), column c residue o_j + c - 1 (code at o_j + c)
    if (tid < W && kind >= 1 && kind <= 3) {
      const int ci = codes[oiv + 1 + tid], cj = codes[ojv + tid];
      if (kind == 1) rowv[tid] = single5[v * 5 + ci];
      if (kind == 2) colv[tid] = single5[v * 5 + cj];
      if (kind == 3) {
        rowc[tid] = ci;
        colc[tid] = cj;
      }
    }
    if (kind == 3 && tid >= kThreads - 32 && tid < kThreads - 32 + 25)
      s_pair[tid - (kThreads - 32)] = pair5[v * 25 + tid - (kThreads - 32)];
    // a regular state's first nslots children come as bulk copies, each
    // issued by the thread that sees its flag; the mbarrier counts them
    const int ncopy = kind >= 0 && kind != kKindE ? min(ndeps, nslots) : 0;
    if (tid == 0 && ncopy > 0) mbar_expect_tx(&s_bar, (uint32_t)(ncopy * WW * sizeof(float)));
    __syncthreads();

    // ---- the self-loop's prefix sums (one thread) while the children are
    // awaited (one thread a child)
    if ((il || ir) && tid == kThreads - 1) {
      // IL: g[r] = d[0] + ... + d[r - 1]; IR: G[c] = d[0] + ... + d[c];
      // d the step (emission + self-loop) clipped at kDead
      const float self_t = __int_as_float(s_row[kWSelf]);
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
    if (tid < ndeps) {
      const int kid = kind < 0 ? s_row[kWLeft + tid] : s_row[kWKid + tid];
      for (int polls = 0; load_acquire(ready + kid) != epoch;)
        if (++polls == kMaxPolls) __trap();
      if (tid < ncopy) {
        // the block was written by the generic proxy, on this SM or
        // another (acquired just now); the copy is the async proxy's
        asm volatile("fence.proxy.async;" ::: "memory");
        bulk_load(slots + tid * WW, deck + (int64_t)kid * WW, (uint32_t)(WW * sizeof(float)),
                  &s_bar);
      }
    }
    // a B state reads its children straight from the deck, and children
    // past the slots are copied later: both wait for every flag
    if (kind < 0 || ndeps > ncopy) __syncthreads();

    float* dst = deck + (int64_t)v * WW;
    float bv = neg_inf();  // this thread's best cell; cells come in increasing index
    int bi = 0x7fffffff;
    // the span validity of column c: j >= i, i and j inside the window
    const int r_end = min(W, L - oiv + 1);

    if (kind == kKindE) {
      if (on) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q;
          if (r < W) {
            const float x = (oiv + r == ojv + c && ojv + c <= L) ? 0.0f : kNeg;
            dst[r * W + c] = x;
            if (x > bv) bv = x, bi = r * W + c;
          }
        }
      }
    } else if (kind < 0) {
      // bifurcation: the two children's blocks aligned to this state's
      // bands, left[r][k] at lbt[k * P + r] and right[k][m] at rbs[k * P + m]
      const int lch = s_row[kWLeft], rch = s_row[kWRight];
      const int ldi = oiv - o_i[lch];
      const int rdi = o_j[lch] - o_i[rch], rdj = ojv - o_j[rch];
      const float* lsrc = deck + (int64_t)lch * WW;
      const float* rsrc = deck + (int64_t)rch * WW;
      if (on) {
        const bool rc_ok = c + rdj >= 0 && c + rdj < W;
        float lv[kRows], rv[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q, lr = r + ldi, rr = r + rdi;
          lv[q] = (r < W && lr >= 0 && lr < W) ? __ldcg(lsrc + lr * W + c) : kNeg;
          rv[q] = (r < W && rc_ok && rr >= 0 && rr < W) ? __ldcg(rsrc + rr * W + c + rdj)
                                                         : kNeg;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q;
          if (r < W) {
            lbt[c * P + r] = lv[q];
            rbs[r * P + c] = rv[q];
          }
        }
      }
      __syncthreads();
      const int ntiles = (W + kTile - 1) / kTile;  // tiles a row (and column)
      const int rt = (tid / ntiles) * kTile, ct = (tid % ntiles) * kTile;
      if (rt < W) {
        float x[kTile][kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) x[i][j] = neg_inf();
        for (int k = 0; k < W; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(lbt + k * P + rt);
          const float4 b = *reinterpret_cast<const float4*>(rbs + k * P + ct);
          const float av[kTile] = {a.x, a.y, a.z, a.w};
          const float bw[kTile] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j) x[i][j] = fmaxf(x[i][j], __fadd_rn(av[i], bw[j]));
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            const int r = rt + i, m = ct + j;
            if (r < W && m < W) {
              const bool ok = m < L - ojv + 1 && r < r_end && r <= m - (oiv - ojv);
              const float y = ok ? fmaxf(x[i][j], kNeg) : kNeg;
              dst[r * W + m] = y;
              if (y > bv) bv = y, bi = r * W + m;
            }
          }
      }
    } else {
      const int nk = ndeps;
      const bool c_in = c < L - ojv + 1;
      const int diag = c - (oiv - ojv);  // valid rows: r <= diag
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = kNeg;
      // the children's blocks, whole, in shared memory (nslots at a time;
      // every caller's W takes all of a state's children at once), read at
      // their offsets
      for (int k0 = 0; k0 < nk; k0 += nslots) {
        const int n = min(nslots, nk - k0);
        if (k0 > 0) {
          __syncthreads();  // every thread is done with the slots
          if (tid == 0) {
            asm volatile("fence.proxy.async;" ::: "memory");
            mbar_expect_tx(&s_bar, (uint32_t)(n * WW * sizeof(float)));
            for (int j = 0; j < n; ++j)
              bulk_load(slots + j * WW, deck + (int64_t)s_kid[k0 + j] * WW,
                        (uint32_t)(WW * sizeof(float)), &s_bar);
          }
        }
        mbar_wait(&s_bar, phase);
        phase ^= 1;
        if (on) {
          for (int j = 0; j < n; ++j) {
            const int di = s_di[k0 + j], dj = s_dj[k0 + j];
            // rows r in [rlo, rlo + span) lie inside the child's block
            const int rlo = max(0, -di), span = min(W, W - di) - rlo;
            if ((unsigned)(c + dj) >= (unsigned)W || span <= 0) continue;
            const float t = __int_as_float(s_row[kWT + k0 + j]);
            // row r = r0 + q of this column is p[q * W]
            const float* p = slots + j * WW + (r0 + di) * W + c + dj;
            const int lo = rlo - r0;
#pragma unroll
            for (int q = 0; q < kRows; ++q)
              if ((unsigned)(q - lo) < (unsigned)span)
                acc[q] = fmaxf(acc[q], __fadd_rn(p[q * W], t));
          }
        }
      }
      // the end, the emission: the state's cells before any self-loop
      if (on) {
        const float end_sc = __int_as_float(s_row[kWEnd]);
        const bool has_end = (flags & kHasEnd) != 0;
        const int span0 = c + ojv - sj - oiv - si;  // the EL span at row 0
        const bool el_col = c < L - (ojv - sj) + 1;  // EL's end inside the window
        const float col_em = kind == 2 ? colv[c] : 0.0f;
        const int col_code = kind == 3 ? colc[c] : 0;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q;
          if (r >= W) continue;
          float x = acc[q];
          if (has_end) {
            const int span = span0 - r;
            const float el = (span >= 0 && el_col) ? __fmul_rn((float)span, el_selfsc) : kNeg;
            x = fmaxf(x, __fadd_rn(el, end_sc));
          }
          if (kind == 1) x = __fadd_rn(x, rowv[r]);
          else if (kind == 2) x = __fadd_rn(x, col_em);
          else if (kind == 3) x = __fadd_rn(x, s_pair[rowc[r] * 5 + col_code]);
          acc[q] = x;
        }
      }
      float* part = slots + WW;  // a self-loop's partial maxima, past blk
      if (il) {
        // blk[r] = max_{k >= r}(blk[k] + g[k]) - g[r] down column c: the
        // suffix maxima of this thread's rows, then the largest of the row
        // groups below it (every child block is read: the slots are free)
        __syncthreads();
        float run = neg_inf();
#pragma unroll
        for (int q = kRows - 1; q >= 0; --q) {
          const int r = r0 + q;
          if (on && r < W) {
            run = fmaxf(run, __fadd_rn(acc[q], pre[r]));
            acc[q] = run;
          }
        }
        if (on) part[tid] = run;
        __syncthreads();
        float carry = neg_inf();
        for (int g = tid + W; on && g < kThreads / W * W && g / W * kRows < W; g += W)
          carry = fmaxf(carry, part[g]);
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (on && r0 + q < W) acc[q] = __fsub_rn(fmaxf(acc[q], carry), pre[r0 + q]);
      } else if (ir) {
        // blk[c] = max_{k <= c}(blk[k] - G[k]) + G[c] along each row: the
        // block through shared memory, thread (r, s) takes the kRows columns
        // from s kRows on, the prefix maxima of its own, then the largest of
        // the segments left of it
        __syncthreads();
        if (on)
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            if (r0 + q < W) blk[(r0 + q) * W + c] = acc[q];
        __syncthreads();
        const int nseg = (W + kRows - 1) / kRows;
        const int row = tid / nseg, k0 = (tid % nseg) * kRows;
        const bool seg_on = tid < W * nseg;
        float y[kRows];
        float run = neg_inf();
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int k = k0 + i;
          if (seg_on && k < W) {
            run = fmaxf(run, __fsub_rn(blk[row * W + k], pre[k]));
            y[i] = run;
          }
        }
        if (seg_on) part[tid] = run;
        __syncthreads();
        float carry = neg_inf();
        for (int s2 = row * nseg; seg_on && s2 < tid; ++s2) carry = fmaxf(carry, part[s2]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int k = k0 + i;
          if (seg_on && k < W) blk[row * W + k] = __fadd_rn(fmaxf(y[i], carry), pre[k]);
        }
        __syncthreads();
        if (on)
#pragma unroll
          for (int q = 0; q < kRows; ++q)
            if (r0 + q < W) acc[q] = blk[(r0 + q) * W + c];
      }
      if (on) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int r = r0 + q;
          if (r < W) {
            const float x = (c_in && r < r_end && r <= diag) ? fmaxf(acc[q], kNeg) : kNeg;
            dst[r * W + c] = x;
            if (x > bv) bv = x, bi = r * W + c;
          }
        }
      }
    }
    // publish: every thread's block writes come before this barrier, and a
    // release store at the scope of the card is cumulative over them; the
    // parents read only the block, so the maximum comes after
    __syncthreads();
    if (tid == 0) store_release(ready + v, epoch);
    reduce_first_max(bv, bi, red_v, red_i, out_m + v, out_a + v);
  }
  // the last block out sets the counters back for the next call
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(done, 1) == (int)gridDim.x - 1) {
      atomicExch(work, 0);
      atomicExch(done, 0);
    }
  }
}

// shared memory: the region and two W-vectors
size_t smem_bytes(int W, int nslots) {
  return (size_t)(region_floats(W, nslots) + 2 * W) * sizeof(float);
}

// what a launch needs of a device and an instantiation, read once: the SM
// count, the opt-in shared memory and the kernel's static shared memory
// (its dynamic limit is raised to the rest at the same time)
struct LaunchInfo {
  bool ready;
  int sms, optin, static_smem;
};
constexpr int kMaxDevices = 64;
LaunchInfo g_launch_info[kMaxDevices][2];
std::mutex g_launch_info_mu;

template <typename Kernel>
cudaError_t launch_info(int dev, int inst, Kernel kernel, LaunchInfo* info) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_launch_info_mu);
  LaunchInfo& li = g_launch_info[dev][inst];
  if (!li.ready) {
    cudaError_t err;
    cudaFuncAttributes fa;
    if ((err = cudaDeviceGetAttribute(&li.sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&li.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    li.optin - (int)fa.sharedSizeBytes)) != cudaSuccess)
      return err;
    li.static_smem = (int)fa.sharedSizeBytes;
    li.ready = true;
  }
  *info = li;
  return cudaSuccess;
}

}  // namespace

// One banded CYK. steps: [n_scan, 20] int32 step table (scores as float32
// bits); order: [n_scan] int32 step rows in dispatch order (every child
// before its parent); e_states: [n_e] int32; single5 [S, 5] and pair5
// [S, 25] float32 (column 4 / code 4: an invalid residue); geo: [2 S + L +
// W + 2] int32, the band origins o_i and o_j then the padded window's codes;
// deck: [S, W, W] float32 scratch (every block is written); out: [2, S]
// int32, each state's block maximum (float32 bits) then its first argmax
// cell r * W + c; sync: [2 + S] int32 or more, the work and done counters
// (0 between calls) then the states' ready flags (each below epoch);
// epoch: larger than every flag.
extern "C" int mfx_cyk_banded(const void* steps, int n_scan, const void* order,
                              const void* e_states, int n_e, const void* single5,
                              const void* pair5, const void* geo, int S, int L, int W,
                              float el_selfsc, void* deck, void* out, void* sync, int epoch,
                              void* stream) {
  if (S <= 0 || n_scan + n_e == 0) return (int)cudaSuccess;
  if (W < 2 || W > kMaxW || W % 2 || L < 0 || n_scan < 0 || n_e < 0 || n_scan + n_e > S ||
      epoch <= 0)
    return (int)cudaErrorInvalidValue;
  // the rRNA refine's width has its own instantiation
  const bool rrna = W == kRrnaW;
  const auto kernel = rrna ? cyk_kernel<kRrnaRows, kRrnaW> : cyk_kernel<kMaxRows, 0>;
  cudaError_t err;
  int dev = 0;
  LaunchInfo li;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = launch_info(dev, rrna ? 1 : 0, kernel, &li)) != cudaSuccess)
    return (int)err;
  // as many whole child blocks as fit beside the static shared memory and
  // the two W-vectors, up to a state's most children
  const long block = (long)W * W * sizeof(float);
  const long room = (long)li.optin - (long)li.static_smem - 2L * W * sizeof(float);
  const int nslots = (int)(room / block < kMaxKids ? room / block : kMaxKids);
  const size_t smem = smem_bytes(W, nslots);
  if (nslots < 1 || (long)smem + (long)li.static_smem > (long)li.optin)
    return (int)cudaErrorInvalidValue;
  const int blocks = li.sms < n_scan + n_e ? li.sms : n_scan + n_e;
  int32_t* o = (int32_t*)out;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)steps, n_scan, (const int32_t*)order, (const int32_t*)e_states, n_e,
      (const float*)single5, (const float*)pair5, (const int32_t*)geo, S, L, W, el_selfsc,
      (float*)deck, (float*)o, o + S, (int*)sync, epoch, nslots);
  return (int)cudaGetLastError();
}
