// Phase clocks of the Newton's two KKT kernels (csrc/structure_kkt.cu,
// csrc/ldl.cu), compiled in with -DKKT_PHASE_CLOCKS (the wrappers'
// build(phase_clocks=True); the Newton solves never ask for it): the thread
// the kernel names (thread 0 of block 0) adds the clock64() cycles since its
// last mark into its phase's slot of g_kkt_clocks. A mark after a barrier
// closes the block's phase; a sync_mark puts a barrier before its mark in
// the clocked build only. Each kernel's library has its own slots, cleared
// and read on the default stream (kkt_clocks_reset, kkt_clocks_read).

#pragma once

#include <cuda_runtime.h>

constexpr int kKktClockSlots = 16;

#ifdef KKT_PHASE_CLOCKS
__device__ long long g_kkt_clocks[kKktClockSlots];

__device__ __forceinline__ long long kkt_cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}

struct PhaseClock {
  bool on;
  long long t;
  __device__ explicit PhaseClock(bool on_) : on(on_), t(0) {
    if (on) t = kkt_cycles();
  }
  __device__ void mark(int slot) {
    if (on) {
      const long long now = kkt_cycles();
      g_kkt_clocks[slot] += now - t;
      t = now;
    }
  }
  __device__ void sync_mark(int slot) {
    __syncthreads();
    mark(slot);
  }
};

extern "C" int kkt_clocks_slots() { return kKktClockSlots; }
extern "C" int kkt_clocks_reset() {
  const long long zero[kKktClockSlots] = {};
  return int(cudaMemcpyToSymbol(g_kkt_clocks, zero, sizeof(zero)));
}
extern "C" int kkt_clocks_read(long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_kkt_clocks, sizeof(long long) * kKktClockSlots));
}
#else
struct PhaseClock {
  __device__ explicit PhaseClock(bool) {}
  __device__ void mark(int) {}
  __device__ void sync_mark(int) {}
};
#endif
