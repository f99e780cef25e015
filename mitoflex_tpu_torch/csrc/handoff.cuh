// Hand-offs between the stages of a pipeline of warps, for Hopper (sm_90a).
//
// A stage posts into a ring of slots in its consumer's shared memory: a
// neighbouring warp's, or across a thread-block cluster the next block's,
// addressed by mapa. Each posted word is 64 bits with its sequence tag in
// the high half, so it validates itself (a relaxed 64-bit store is
// single-copy atomic): the consumer issues its loads and again until every
// word carries the tag it waits for, and no fence or flag is needed. The
// consumer's ack (the count of slots consumed), in the producer's shared
// memory, keeps the producer at most a ring's depth (its user's kDepth)
// slots ahead. A pair of
// neighbouring words may move in one 16-byte access: each 8-byte element of
// a vector access is itself single-copy atomic. Used by viterbi.cu and
// row_pipeline.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Rings and ack words are read only by the warp that owns them (volatile
// loads of this block's shared memory) and written by their neighbour,
// through shared::cluster addresses (this block's, or another block's of
// the cluster from mapa).
__device__ __forceinline__ uint64_t ld_word(uint32_t a) {
  uint64_t v;
  asm volatile("ld.volatile.shared.b64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}

// two neighbouring tagged words (16-byte aligned) in one load
__device__ __forceinline__ void ld_word2(uint32_t a, uint64_t& v0, uint64_t& v1) {
  asm volatile("ld.volatile.shared.v2.b64 {%0, %1}, [%2];" : "=l"(v0), "=l"(v1) : "r"(a) : "memory");
}

__device__ __forceinline__ uint32_t ld_ack(uint32_t a) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// a tagged word into a neighbour's ring: another block's (remote) or this
// block's (a plain shared store)
__device__ __forceinline__ void st_word(bool remote, uint32_t a, uint32_t tag, uint32_t bits) {
  const uint64_t v = ((uint64_t)tag << 32) | bits;
  if (remote)
    asm volatile("st.relaxed.cluster.shared::cluster.b64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
  else
    asm volatile("st.volatile.shared.b64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}

__device__ __forceinline__ void st_ack(bool remote, uint32_t a, uint32_t v) {
  if (remote)
    asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
  else
    asm volatile("st.volatile.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// two neighbouring tagged words (16-byte aligned) in one store, where p holds
__device__ __forceinline__ void st_word2_if(bool p, bool remote, uint32_t a, uint32_t tag,
                                            uint32_t b0, uint32_t b1) {
  const uint64_t v0 = ((uint64_t)tag << 32) | b0;
  const uint64_t v1 = ((uint64_t)tag << 32) | b1;
  asm volatile(
      "{\n\t.reg .pred pr, pl;\n\t"
      "setp.ne.b32 pr, %3, 0;\n\t"
      "setp.ne.b32 pl, %4, 0;\n\t"
      "@pr st.relaxed.cluster.shared::cluster.v2.b64 [%0], {%1, %2};\n\t"
      "@pl st.volatile.shared.v2.b64 [%0], {%1, %2};\n\t}"
      ::"r"(a), "l"(v0), "l"(v1), "r"((int)(p && remote)), "r"((int)(p && !remote))
      : "memory");
}

// st_ack where p holds, without a branch (a predicated store)
__device__ __forceinline__ void st_ack_if(bool p, bool remote, uint32_t a, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred pr, pl;\n\t"
      "setp.ne.b32 pr, %2, 0;\n\t"
      "setp.ne.b32 pl, %3, 0;\n\t"
      "@pr st.relaxed.cluster.shared::cluster.u32 [%0], %1;\n\t"
      "@pl st.volatile.shared.u32 [%0], %1;\n\t}"
      ::"r"(a), "r"(v), "r"((int)(p && remote)), "r"((int)(p && !remote)) : "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ bool has_tag(uint64_t v, uint32_t tag) {
  return (uint32_t)(v >> 32) == tag;
}

// tagged words in device memory, for a hand-off between blocks that a ring
// cannot hold (relaxed at gpu scope: seen by every SM once written)
__device__ __forceinline__ uint64_t ld_global_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_global_word_if(bool q, uint64_t* p, uint32_t tag,
                                                  uint32_t bits) {
  const uint64_t v = ((uint64_t)tag << 32) | bits;
  asm volatile(
      "{\n\t.reg .pred pq;\n\t"
      "setp.ne.b32 pq, %2, 0;\n\t"
      "@pq st.relaxed.gpu.global.b64 [%0], %1;\n\t}"
      ::"l"(p), "l"(v), "r"((int)q) : "memory");
}

}  // namespace
