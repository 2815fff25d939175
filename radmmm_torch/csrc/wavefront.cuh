// Pieces shared by the row-serial wavefront kernels (ctc_beta_kernel in
// ctc_band_dp.cu, mas_width1.cu): 4-byte cp.async ring copies, and the edge
// hand-off between the warps of a wavefront.
//
// Every function takes a 32-bit shared-memory address, converted once per
// kernel with smem_u32: a generic pointer converted inside the row loop
// costs a read of the CTA's cluster rank (S2R SR_CgaCtaId) at each copy in
// the code nvcc makes for sm_90a.
//
// Edge hand-off: a producing warp stores each row's edge value together
// with the row's index as one 64-bit shared-memory word; a consuming warp
// spins on that word until the index is the row it needs. The value and
// its index arrive in one single-copy-atomic access, so neither side needs
// a fence. The consumer publishes the last row it read in a progress word,
// and the producer waits on it before it reuses a slot of the ring, so a
// slot is never overwritten before it was read.
#pragma once

#include <cuda_runtime.h>

namespace wavefront {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a 4-byte asynchronous copy into shared memory, in per-thread groups
__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slots of an edge ring, one row each
constexpr int kEdgeRows = 32;

// A spin that outlasts this many polls (seconds on an H100) means a
// producer that never comes: trap, so the launch fails instead of hanging.
constexpr unsigned kSpinLimit = 1u << 26;

__device__ __forceinline__ void spin_guard(unsigned& polls) {
  if (++polls > kSpinLimit) __trap();
}

__device__ __forceinline__ unsigned long long edge_word(int row, float v) {
  return ((unsigned long long)(unsigned)row << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void edge_store(unsigned slot, int row, float v) {
  asm volatile("st.relaxed.cta.shared.b64 [%0], %1;\n" ::"r"(slot),
               "l"(edge_word(row, v))
               : "memory");
}

// spin until the slot holds `row`, then return its value
__device__ __forceinline__ float edge_wait(unsigned slot, int row) {
  unsigned long long w;
  unsigned polls = 0;
  for (;;) {
    asm volatile("ld.relaxed.cta.shared.b64 %0, [%1];\n"
                 : "=l"(w)
                 : "r"(slot)
                 : "memory");
    if ((int)(w >> 32) == row) break;
    spin_guard(polls);
  }
  return __uint_as_float((unsigned)w);
}

// both slots of a two-value edge (16-byte aligned) in one load a poll;
// each half carries its own row, so each is checked on its own
__device__ __forceinline__ void edge_wait2(unsigned slot, int row, float& v0,
                                           float& v1) {
  unsigned long long w0, w1;
  unsigned polls = 0;
  for (;;) {
    asm volatile("ld.volatile.shared.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(w0), "=l"(w1)
                 : "r"(slot)
                 : "memory");
    if ((int)(w0 >> 32) == row && (int)(w1 >> 32) == row) break;
    spin_guard(polls);
  }
  v0 = __uint_as_float((unsigned)w0);
  v1 = __uint_as_float((unsigned)w1);
}

__device__ __forceinline__ void progress_store(unsigned p, int v) {
  asm volatile("st.relaxed.cta.shared.b32 [%0], %1;\n" ::"r"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int progress_load(unsigned p) {
  int v;
  asm volatile("ld.relaxed.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(p)
               : "memory");
  return v;
}

// Before a producer stores row `row` into slot row % kEdgeRows: wait until
// the consumer has read row - kEdgeRows, the slot's previous row. `seen`
// caches the consumer's progress (rows read), so the wait costs a load
// only about once every kEdgeRows rows.
__device__ __forceinline__ void edge_reserve(unsigned consumed, int row,
                                             int& seen) {
  unsigned polls = 0;
  while (seen < row - kEdgeRows + 1) {
    seen = progress_load(consumed);
    spin_guard(polls);
  }
}

// The edge ring's slots hold no row before the first store.
__device__ __forceinline__ void edge_clear(unsigned long long* ring, int n,
                                           int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) ring[i] = edge_word(-1, 0.f);
}

}  // namespace wavefront
