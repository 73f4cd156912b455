// In-kernel phase timers of the recurrent cores (rnn_bwd_chain.cuh,
// rnn_fwd_chain.cuh and the 2-layer rnn2_bwd_chain.cuh, rnn2_fwd_chain.cuh).
//
// Built with -DRNN_CHAIN_TIMERS=1, each warp adds the clock64() time of
// every phase of its step loop into seven buckets, and lane 0 of each warp
// adds its sums into rnn_timer::totals[] when the kernel ends, with a count
// of the warps after them, in the block of its CTA set (the one-layer
// cores' only set, or a 2-layer core's lead set 0 and follow set 1); the C
// entry <source>_timers(host, reset) copies both blocks out (and zeroes
// them).  The
// default build (RNN_CHAIN_TIMERS 0) compiles every call below away, so
// the timed build is the real kernel with clock reads added.  Used by
// scripts/chain_ab.py --timers.
//
// The buckets: the grid barrier's wait; the exchange (the previous step's
// row block arriving, up to its last value); the products; the shuffle and
// shared-memory reduction with its __syncthreads; the cell (residual wait,
// math, stores); the cluster barrier and the partials read from the
// cluster's other CTAs, and the block barriers between the chunks of the
// exchange (waiting for the other warps).

#pragma once

#include <cuda_runtime.h>

#ifndef RNN_CHAIN_TIMERS
#define RNN_CHAIN_TIMERS 0
#endif

namespace rnn_timer {

enum Bucket {
  kBarrier = 0, kExchange, kProducts, kReduce, kCell, kCluster, kSync, kCount
};

constexpr int kSets = 2;  // a 2-layer core's lead and follow sets

#if RNN_CHAIN_TIMERS
__device__ unsigned long long totals[kSets * (kCount + 1)];  // per set: + the warps

struct Timer {
  long long prev;
  long long acc[kCount];
  float sink;  // keeps wait()'s values live

  __device__ __forceinline__ static long long now() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return t;
  }
  __device__ __forceinline__ Timer() : prev(now()), sink(0.0f) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) acc[i] = 0;
  }
  // charge the time since the last mark to bucket b
  __device__ __forceinline__ void mark(int b) {
    const long long t = now();
    acc[b] += t - prev;
    prev = t;
  }
  // make the next mark wait until x has arrived (a load's result)
  __device__ __forceinline__ void wait(float x) {
    asm volatile("add.f32 %0, %0, %1;" : "+f"(sink) : "f"(x) : "memory");
  }
  __device__ __forceinline__ void flush(int set = 0) {
    unsigned long long* out = totals + set * (kCount + 1);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kCount; ++i) {
        atomicAdd(&out[i], (unsigned long long)acc[i]);
      }
      atomicAdd(&out[kCount], 1ull);
    }
    if (sink == 1.5e-38f) atomicAdd(&totals[0], 0ull);  // never true
  }
};
#else
struct Timer {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void wait(float) {}
  __device__ __forceinline__ void flush(int = 0) {}
};
#endif

}  // namespace rnn_timer

// <name>_timers(host, reset): copy each set's seven buckets and warp count
// into host (unsigned long long[16]) and, if reset, zero them.  Only timed
// builds have it.
#if RNN_CHAIN_TIMERS
#define RNN_TIMERS_EXPORT(name)                                               \
  extern "C" int name##_timers(unsigned long long* host, int reset) {        \
    cudaError_t err = cudaDeviceSynchronize();                                \
    if (err != cudaSuccess) return err;                                       \
    err = cudaMemcpyFromSymbol(host, rnn_timer::totals,                       \
                               sizeof(rnn_timer::totals));                    \
    if (err != cudaSuccess || !reset) return err;                             \
    const unsigned long long zero[rnn_timer::kSets * (rnn_timer::kCount + 1)] = {}; \
    return cudaMemcpyToSymbol(rnn_timer::totals, zero, sizeof(zero));         \
  }
#else
#define RNN_TIMERS_EXPORT(name)
#endif
