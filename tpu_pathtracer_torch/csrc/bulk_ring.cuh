// Staging by TMA 1-D bulk copies into a ring of shared-memory slots, each
// with an mbarrier, shared by grouped_closest.cu (K12) and
// grouped_anyhit.cu (K13): a shared address, an mbarrier's set-up and
// wait, a copy that completes on its slot's mbarrier, a row's load from a
// slot or through L1, and the wait for a slot's copy. Device code only.
// The build hashes every header of csrc/ with the source, so an edit here
// rebuilds both.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ bool bar_try_wait(unsigned long long* bar,
                                             unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Copy `bytes` into a ring slot, completing on its mbarrier `bar`, and
// count the copy in `issued` (the slot's copies so far).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          int* issued) {
  // the slot's earlier reads (generic proxy) before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
  __threadfence_block();
  *reinterpret_cast<volatile int*>(issued) += 1;
}

// A pack row's float4 (or float): from a ring slot in shared memory
// (kStaged) or from global memory through L1.
template <bool kStaged, class T>
__device__ __forceinline__ T row_load(const T* p) {
  if constexpr (kStaged) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Wait until copy `use` of a slot has landed: first until it is issued (a
// parity alone cannot tell use v from use v - 2, and would pass while use
// v - 1 is in flight), then for its phase. Returns false, without waiting
// on, once *left is 0 (left: null where nothing ends the walk early). A
// copy that never comes is a fault of the kernel: it traps, not hangs.
__device__ __forceinline__ bool wait_slot(const int* issued,
                                          unsigned long long* bar, int use,
                                          const int* left) {
  const volatile int* vi = issued;
  const volatile int* vl = left;
  for (long long spin = 0; vi[0] <= use; ++spin) {
    if (vl && *vl == 0) return false;
    if (spin > (1ll << 26)) __trap();
  }
  __threadfence_block();
  for (long long spin = 0; !bar_try_wait(bar, use & 1); ++spin) {
    if (spin > (1ll << 26)) __trap();
  }
  return true;
}

}  // namespace
