// Read quality filter for Hopper (sm_90a).
//
// Replaces mitoflex_tpu/ops/filter.py::_filter_kernel (the Pallas body that
// filter_reads_pallas launches). Per read, within its length: the count of
// N bases (code 4), the count of raw phred+33 bytes <= quality_valve,
// keep = n <= ns_valve && bad < floor(f32(cutoff_len) * f32(pct)), and two
// uint32 polynomial hashes sum((code + 1) * B^i). Results are bit-identical
// to filter_reads_ref.
//
// What bounds it on the H100: device-memory bytes. A read moves 2L + 8
// bytes in (bases, qualities, length, cutoff length) and 9 out, and does a
// few integer operations per base, far below the card's
// operations-per-byte balance. So the aim is one pass over the bytes, in
// the widest loads the card has, with no other memory traffic.
//
// Design (vector path, L % 16 == 0 and 16-byte aligned rows):
// - a lane loads one int4 of 16 bases and one int4 of 16 qualities; a group
//   of G = L / 16 consecutive lanes holds one read and a warp holds
//   floor(32 / G) reads (two at L = 256, three at L = 160), so a warp-wide
//   load is one run of consecutive 16-byte pieces. A lane whose 16 columns
//   lie wholly past the read's length loads nothing.
// - the N and low-quality counts are taken on packed bytes (__vcmpeq4,
//   __vcmples4, __popc); the columns past the length are masked per byte.
// - a lane's hash contribution is B^(16 g) * sum_t (code_t + 1) * B^t in
//   wrapping uint32 arithmetic. The sixteen B^t are compile-time constants,
//   and B^(16 g) is a product of up to five compile-time constants chosen
//   by the bits of g, so no power is read from memory. The sum is a
//   reordering of exact arithmetic mod 2^32: the bits do not change.
// - the cutoff is computed per read with __fmul_rn (no contraction), as the
//   float32 product of the plain version.
// - a segmented shuffle reduction over the G lanes gives the read's totals
//   (the two counts share one word); the group's first lane writes.
// The scalar path (any L, any alignment) runs the same arithmetic with one
// warp a read and byte loads; the launcher chooses between them by L and
// the pointers' alignment.
//
// The Pallas kernel's int32 indicator arithmetic and its cutoffs input were
// Mosaic constraints (no unsigned reductions, no scalar float in SMEM);
// neither is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNCode = 4;
constexpr uint32_t kB1 = 0x01000193u;  // FNV prime
constexpr uint32_t kB2 = 0x85EBCA6Bu;  // murmur3 c2

// B^T mod 2^32 at compile time (by squaring, so the recursion stays shallow)
template <uint32_t B, int T>
struct PowC {
  static constexpr uint32_t half = PowC<B, T / 2>::v;
  static constexpr uint32_t v = half * half * ((T & 1) ? B : 1u);
};
template <uint32_t B>
struct PowC<B, 0> {
  static constexpr uint32_t v = 1u;
};

// B^(step * g) for g < 32: a product of constants chosen by the bits of g
template <uint32_t B, int STEP>
__device__ __forceinline__ uint32_t pow_of(int g) {
  uint32_t p = 1u;
  if (g & 1) p *= PowC<B, STEP>::v;
  if (g & 2) p *= PowC<B, 2 * STEP>::v;
  if (g & 4) p *= PowC<B, 4 * STEP>::v;
  if (g & 8) p *= PowC<B, 8 * STEP>::v;
  if (g & 16) p *= PowC<B, 16 * STEP>::v;
  return p;
}

// (code + 1) of byte K of w, as the plain version's (uint32)((int)code + 1)
template <int K>
__device__ __forceinline__ uint32_t plus1(uint32_t w) {
  return (uint32_t)((int)(int8_t)(w >> (8 * K)) + 1);
}

// sum over the four bytes of w, at columns T0 .. T0 + 3 of the lane's 16
template <uint32_t B, int T0>
__device__ __forceinline__ uint32_t word_sum(uint32_t w) {
  return plus1<0>(w) * PowC<B, T0>::v + plus1<1>(w) * PowC<B, T0 + 1>::v +
         plus1<2>(w) * PowC<B, T0 + 2>::v + plus1<3>(w) * PowC<B, T0 + 3>::v;
}

// 0xff in each of the first n bytes (n <= 0: none, n >= 4: all)
__device__ __forceinline__ uint32_t first_bytes(int n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

__device__ __forceinline__ int cutoff_of(int cutoff_len, float pct) {
  return (int)floorf(__fmul_rn((float)cutoff_len, pct));
}

// Vector path: G = L / 16 lanes a read, reads_per_warp = 32 / G.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
filter_reads_vec_kernel(
    const int4* __restrict__ seqs, const int4* __restrict__ quals,
    const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ cutoff_lengths, int64_t n_reads, int G,
    int reads_per_warp, int ns_valve, uint32_t qv_bytes, uint32_t bad_mask,
    float pct, uint8_t* __restrict__ keep, uint32_t* __restrict__ h1,
    uint32_t* __restrict__ h2) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int slot = lane / G;  // the lane's read within the warp
  const int g = lane - slot * G;
  const int64_t read = warp * reads_per_warp + slot;
  const bool active = slot < reads_per_warp && read < n_reads;
  // every lane stays for the shuffles; an idle one carries zeros
  uint32_t counts = 0u;  // bad << 16 | n (each at most 16 a lane, 512 a read)
  uint32_t a1 = 0u;
  uint32_t a2 = 0u;
  int len = 0;
  if (active) {
    len = lengths[read];
    const int n_valid = min(len, 16 * G) - 16 * g;  // of this lane's columns
    if (n_valid > 0) {
      const int4 s = __ldg(seqs + read * G + g);
      const int4 q = __ldg(quals + read * G + g);
      const uint32_t sw[4] = {(uint32_t)s.x, (uint32_t)s.y, (uint32_t)s.z,
                              (uint32_t)s.w};
      const uint32_t qw[4] = {(uint32_t)q.x, (uint32_t)q.y, (uint32_t)q.z,
                              (uint32_t)q.w};
      uint32_t m[4];
      uint32_t n_bits = 0u;
      uint32_t bad_bits = 0u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t mask = first_bytes(n_valid - 4 * w);
        // a column past the length reads as code -1: no N, and code + 1 = 0
        m[w] = sw[w] | ~mask;
        n_bits += __popc(__vcmpeq4(m[w], 0x01010101u * kNCode));
        bad_bits += __popc(__vcmples4(qw[w], qv_bytes) & mask & bad_mask);
      }
      counts = (bad_bits >> 3) << 16 | (n_bits >> 3);
      a1 = (word_sum<kB1, 0>(m[0]) + word_sum<kB1, 4>(m[1]) +
            word_sum<kB1, 8>(m[2]) + word_sum<kB1, 12>(m[3])) *
           pow_of<kB1, 16>(g);
      a2 = (word_sum<kB2, 0>(m[0]) + word_sum<kB2, 4>(m[1]) +
            word_sum<kB2, 8>(m[2]) + word_sum<kB2, 12>(m[3])) *
           pow_of<kB2, 16>(g);
    }
  }
  // segmented sum over the group's G consecutive lanes, into its first
  for (int off = 1; off < G; off <<= 1) {
    const uint32_t c = __shfl_down_sync(0xffffffffu, counts, off);
    const uint32_t x1 = __shfl_down_sync(0xffffffffu, a1, off);
    const uint32_t x2 = __shfl_down_sync(0xffffffffu, a2, off);
    if (g + off < G) {
      counts += c;
      a1 += x1;
      a2 += x2;
    }
  }
  if (active && g == 0) {
    const int n_count = (int)(counts & 0xffffu);
    const int bad = (int)(counts >> 16);
    keep[read] =
        (n_count <= ns_valve) && (bad < cutoff_of(cutoff_lengths[read], pct));
    h1[read] = a1;
    h2[read] = a2;
  }
}

// Scalar path: one warp a read, lanes strided over the columns.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
filter_reads_scalar_kernel(
    const int8_t* __restrict__ seqs, const int8_t* __restrict__ quals,
    const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ cutoff_lengths, int64_t n_reads, int L,
    int ns_valve, int quality_valve, float pct, uint8_t* __restrict__ keep,
    uint32_t* __restrict__ h1, uint32_t* __restrict__ h2) {
  const int lane = threadIdx.x & 31;
  const int64_t read =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // the whole warp shares one read, so it leaves together (the shuffles
  // below need every lane of the mask)
  if (read >= n_reads) return;
  const int len = min(lengths[read], L);
  const int8_t* s = seqs + read * L;
  const int8_t* q = quals + read * L;
  int n_count = 0;
  int bad = 0;
  uint32_t a1 = 0u;
  uint32_t a2 = 0u;
  uint32_t p1 = pow_of<kB1, 1>(lane);  // B^j for the lane's column j
  uint32_t p2 = pow_of<kB2, 1>(lane);
  for (int j = lane; j < len; j += 32) {
    const int code = s[j];
    n_count += code == kNCode;
    bad += (int)q[j] <= quality_valve;
    const uint32_t v = (uint32_t)(code + 1);
    a1 += v * p1;
    a2 += v * p2;
    p1 *= PowC<kB1, 32>::v;
    p2 *= PowC<kB2, 32>::v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    n_count += __shfl_xor_sync(0xffffffffu, n_count, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
  }
  if (lane == 0) {
    keep[read] =
        (n_count <= ns_valve) && (bad < cutoff_of(cutoff_lengths[read], pct));
    h1[read] = a1;
    h2[read] = a2;
  }
}

}  // namespace

// hashes: [2, n_reads] uint32, h1 in row 0 and h2 in row 1.
extern "C" int mfx_filter_reads(
    const void* seqs, const void* quals, const void* lengths,
    const void* cutoff_lengths, int64_t n_reads, int L, int ns_valve,
    int quality_valve, float pct, void* keep, void* hashes, void* stream) {
  if (n_reads <= 0 || L <= 0) return (int)cudaSuccess;
  uint32_t* h1 = (uint32_t*)hashes;
  uint32_t* h2 = h1 + n_reads;
  const bool vec = L % 16 == 0 && L <= 512 &&
                   ((uintptr_t)seqs | (uintptr_t)quals) % 16 == 0;
  if (vec) {
    const int G = L / 16;
    const int reads_per_warp = 32 / G;
    const int64_t warps = (n_reads + reads_per_warp - 1) / reads_per_warp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    // the signed per-byte compare sees the valve clamped to an int8; below
    // -128 no byte can be <= it, and bad_mask clears every flag
    const int qv = quality_valve > 127 ? 127 : quality_valve;
    const uint32_t bad_mask = qv < -128 ? 0u : 0xffffffffu;
    const uint32_t qv_bytes = 0x01010101u * (uint32_t)(uint8_t)(int8_t)qv;
    filter_reads_vec_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(
        (const int4*)seqs, (const int4*)quals, (const int32_t*)lengths,
        (const int32_t*)cutoff_lengths, n_reads, G, reads_per_warp, ns_valve,
        qv_bytes, bad_mask, pct, (uint8_t*)keep, h1, h2);
  } else {
    const int64_t blocks = (n_reads + kWarpsPerBlock - 1) / kWarpsPerBlock;
    filter_reads_scalar_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                 (cudaStream_t)stream>>>(
        (const int8_t*)seqs, (const int8_t*)quals, (const int32_t*)lengths,
        (const int32_t*)cutoff_lengths, n_reads, L, ns_valve, quality_valve,
        pct, (uint8_t*)keep, h1, h2);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mfx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
