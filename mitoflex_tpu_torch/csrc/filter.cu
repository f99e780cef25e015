// Read quality filter for Hopper (sm_90a).
//
// Replaces mitoflex_tpu/ops/filter.py::_filter_kernel (the Pallas body that
// filter_reads_pallas launches). Per read, within its length: the count of
// N bases (code 4), the count of raw phred+33 bytes <= quality_valve,
// keep = n <= ns_valve && bad < cutoff, and two uint32 polynomial hashes
// sum((code + 1) * B^i) whose powers come from a table the wrapper builds.
// Results are bit-identical to filter_reads_ref.
//
// What bounds it on the H100: device-memory bytes. A read moves 2L + 12
// bytes (bases, qualities, length, cutoff) and does a few integer operations
// per base, far below the card's operations-per-byte balance, so the only
// aim is one pass over the bytes with nothing written but the outputs.
// Design: one warp per read, lanes strided over the L <= 256 columns so a
// warp-wide load touches 32 consecutive bytes of the row; warp-shuffle
// reductions give the two counts and both hashes; lane 0 writes the three
// results. The Pallas kernel's int32 indicator arithmetic was a Mosaic
// constraint (no unsigned reductions); here the hashes are native uint32
// multiply-adds that wrap like the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNCode = 4;

__global__ void filter_reads_kernel(
    const int8_t* __restrict__ seqs, const int8_t* __restrict__ quals,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ cutoffs,
    const uint32_t* __restrict__ p1, const uint32_t* __restrict__ p2,
    int64_t n_reads, int L, int ns_valve, int quality_valve,
    uint8_t* __restrict__ keep, uint32_t* __restrict__ h1,
    uint32_t* __restrict__ h2) {
  const int lane = threadIdx.x & 31;
  const int64_t read =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // the whole warp shares one read, so it leaves together (the shuffles
  // below need every lane of the mask)
  if (read >= n_reads) return;
  const int len = lengths[read];
  const int8_t* s = seqs + read * L;
  const int8_t* q = quals + read * L;
  int n_count = 0;
  int bad = 0;
  uint32_t a1 = 0u;
  uint32_t a2 = 0u;
  for (int j = lane; j < L && j < len; j += 32) {
    const int code = s[j];
    n_count += code == kNCode;
    bad += (int)q[j] <= quality_valve;
    const uint32_t v = (uint32_t)code + 1u;
    a1 += v * p1[j];
    a2 += v * p2[j];
  }
  for (int off = 16; off > 0; off >>= 1) {
    n_count += __shfl_xor_sync(0xffffffffu, n_count, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
  }
  if (lane == 0) {
    keep[read] = (n_count <= ns_valve) && (bad < cutoffs[read]);
    h1[read] = a1;
    h2[read] = a2;
  }
}

}  // namespace

extern "C" int mfx_filter_reads(
    const void* seqs, const void* quals, const void* lengths,
    const void* cutoffs, const void* p1, const void* p2, int64_t n_reads,
    int L, int ns_valve, int quality_valve, void* keep, void* h1, void* h2,
    void* stream) {
  if (n_reads <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n_reads + kWarpsPerBlock - 1) / kWarpsPerBlock;
  filter_reads_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
      (const int8_t*)seqs, (const int8_t*)quals, (const int32_t*)lengths,
      (const int32_t*)cutoffs, (const uint32_t*)p1, (const uint32_t*)p2,
      n_reads, L, ns_valve, quality_valve, (uint8_t*)keep, (uint32_t*)h1,
      (uint32_t*)h2);
  return (int)cudaGetLastError();
}

extern "C" const char* mfx_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
