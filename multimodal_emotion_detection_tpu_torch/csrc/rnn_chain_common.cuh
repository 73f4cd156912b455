// What the recurrent cores for Hopper (sm_90a) share: the one-layer
// rnn_bwd_chain.cuh (the reverse chains, rows 4 and 7) and
// rnn_fwd_chain.cuh (the forwards, rows 6 and 7f with their eval forms),
// and the 2-layer rnn2_bwd_chain.cuh (rows 15 and 12) and rnn2_fwd_chain.cuh
// (rows 3 and 2, with their training forms 14 and 11), which run two such
// sets of CTAs, one per layer, in one launch.
//
// All run one persistent cooperative launch of H / UPC CTAs a set, one per SM,
// cut into row groups and clusters that split the exchanged row's columns
// (the launch plan of ops/lstm_kernel.py::chain_plan, re-checked by each
// core's launcher), and both walk T steps of
//
//   out[b][o] = sum_k x[b][k] W[o][k]
//
// over the row block x the previous step wrote.  Here: the constants of
// the thread layout, the cp.async row copies, the flag barrier's
// release / acquire, the cluster barrier, the warps' shuffle
// reduce-scatter, the shared-memory padding rule and the launch checks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace rnn_chain {

constexpr int NT = 256;            // threads per CTA
constexpr int PH = 8;              // batch rows per pass
constexpr int kUnsupported = -1;   // shape the kernel does not take
constexpr int kPlanMismatch = -2;  // plan not valid for this shape / card
constexpr int kNotResident = -3;   // the clusters cannot all be resident
constexpr int kFlagsPerGroup = 256;  // barrier flags of a row group (>= its CTAs)

__host__ __device__ constexpr int round32(int x) { return (x + 31) / 32 * 32; }

// shared memory a launch asks for: the plan's, padded past half an SM's so
// one CTA fits an SM
__host__ __device__ inline int smem_launch_bytes(int need_bytes, int max_smem) {
  const int floor_bytes = max_smem / 2 + 2048;
  return need_bytes > floor_bytes ? need_bytes : floor_bytes;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Residual storage.  Each core's training forms store, and its chains read,
// the residual series in a storage type S: float, or bf16 (the JAX
// package's runtime.lstm_residual_dtype "bfloat16"), each value rounded
// once, to nearest even, from the float32 value the float32 form stores,
// and read back into float32.  The cells' arithmetic, the carries, the
// finals and the exchange between steps and layers stay float32 in both.
using bf16 = __nv_bfloat16;

template <class S>
__device__ __forceinline__ void st_res(S* p, float v) {
  if constexpr (std::is_same_v<S, float>) {
    *p = v;
  } else {
    *p = __float2bfloat16_rn(v);
  }
}
__device__ __forceinline__ float ld_res(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_res(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Whether S is the bf16 form's storage.
template <class S>
constexpr bool kHalfStore = !std::is_same_v<S, float>;

// The series of storage type S of a pair of Args fields: the float32
// form's, or the bf16 form's.
template <class S, class P32, class P16>
__device__ __forceinline__ auto res_of(P32 p32, P16 p16) {
  if constexpr (std::is_same_v<S, float>) {
    return p32;
  } else {
    return p16;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most n groups are pending (n clamped to 0..7)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n <= 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
// A CTA's transaction barrier (mbarrier) in shared memory and the bulk
// copies (TMA, cp.async.bulk) that complete on it: one thread arms a phase
// with the bytes it expects, any threads start copies of 16-byte multiples
// that count them off, and every thread waits for the phase's parity.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// (a phase that never completes is a fault: end the launch with an error
// after ~20 s, as the flag barrier does)
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 40000000000ll) __trap();
  }
}
__device__ __forceinline__ void cluster_sync_() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The flag barrier's wait, by warp 0: every one of the n flags (a row
// group's CTAs) has counted at least `done` steps; a lane polls each
// flag.  A CTA that never arrives is a fault: end the launch with an
// error after ~20 s rather than hold the card.
__device__ __forceinline__ void wait_flags(const unsigned* flags, int n,
                                           unsigned done, int lane) {
  const long long start = clock64();
  for (int i = lane; i < n; i += 32) {
    while (ld_acquire(flags + i) < done) {
      if (clock64() - start > 40000000000ll) __trap();
    }
  }
}

// The same over two blocks of n flags at once (a 2-layer core's own set
// and the other set): those at a have counted at least da steps, those at
// b at least db; the lanes poll both blocks' flags together.
__device__ __forceinline__ void wait_flags2(const unsigned* a, unsigned da,
                                            const unsigned* b, unsigned db, int n,
                                            int lane) {
  const long long start = clock64();
  for (int i = lane; i < 2 * n; i += 32) {
    const unsigned* f = i < n ? a + i : b + (i - n);
    const unsigned done = i < n ? da : db;
    while (ld_acquire(f) < done) {
      if (clock64() - start > 40000000000ll) __trap();
    }
  }
}

// One chunk of rows into shared memory by cp.async, one commit group:
// float4 columns [0, kn) of rows [0, nb) from src(r, c) (a row's float4
// column) to dst + r ldx + 4 c; a thread walks (row, column) by
// increments, no division in the loop.
template <class Src>
__device__ __forceinline__ void copy_rows(const Src& src, int nb, int kn,
                                          float* dst, int ldx, int tid) {
  if (kn > 0) {
    int r = tid / kn, c = tid % kn;
    const int dr = NT / kn, dc = NT % kn;
    while (r < nb) {
      cp_async16(dst + r * ldx + 4 * c, src(r, c));
      r += dr;
      c += dc;
      if (c >= kn) {
        c -= kn;
        ++r;
      }
    }
  }
  cp_async_commit();
}

// How many levels of warp_reduce_scatter<N0, L> halve the values: as many
// as halve an even count, at most log2 L.
__host__ __device__ constexpr int scatter_levels(int n0, int lanes) {
  return lanes <= 1 || n0 % 2 != 0 ? 0 : 1 + scatter_levels(n0 / 2, lanes / 2);
}

// One level of warp_reduce_scatter: the lanes hold N values each; with N
// even each lane keeps one half (the upper where lane & O) and is sent its
// partner's copy of it, else both add all N values.
template <int N, int O>
__device__ __forceinline__ void reduce_scatter_level(float* v, int lane) {
  if constexpr (N % 2 == 0) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
  }
}

template <int N, int O>
__device__ __forceinline__ void reduce_scatter_from(float* v, int lane) {
  if constexpr (O >= 1) {
    reduce_scatter_level<N, O>(v, lane);
    reduce_scatter_from<(N % 2 == 0 ? N / 2 : N), O / 2>(v, lane);
  }
}

// The N0 partial sums of each aligned group of L lanes (L a power of two
// up to 32) meet, unrolled at compile time.  With S = scatter_levels(N0,
// L) and NF = N0 >> S, lane l of a group then holds the totals of values
// NF (l >> (log2 L - S)) + [0, NF) in v[0 ..], the same in each of the
// L >> S lanes that share the bits above.  For N0 a power of two and
// L = 32: N0 >= 32 leaves lane l the values l (N0 / 32) + v; N0 < 32 the
// value l >> (5 - log2 N0).  N0 - NF shuffles, plus NF for each level
// past S.
template <int N0, int L = 32>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N0], int lane) {
  reduce_scatter_from<N0, L / 2>(v, lane);
}

// The launch configuration of a plan's kernel fn: grid CTAs in clusters of
// ncl with need_bytes of shared memory; kPlanMismatch where it does not
// fit the card.
inline int configure(const void* fn, int grid, int ncl, int need_bytes,
                     cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (fn == nullptr || need_bytes > max_smem) return kPlanMismatch;
  const int smem = smem_launch_bytes(need_bytes, max_smem);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launch a configured plan cooperatively with its cluster dimension,
// after checking that all its clusters are resident at once (attr has
// room for two attributes).
inline int launch_resident(const void* fn, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int ncl, void** args,
                           cudaStream_t stream) {
  int clusters = 0;
  int err = cudaOccupancyMaxActiveClusters(&clusters, fn, cfg);
  if (err != cudaSuccess) return err;
  if ((long long)clusters * ncl < (long long)cfg->gridDim.x) return kNotResident;
  cfg->stream = stream;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg->numAttrs = 2;
  err = cudaLaunchKernelExC(cfg, fn, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The card's SM count and shared memory per block (the plan's inputs).
inline int card_limits(int* sms, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Whether a plan's counts are ones the kernels are built for, and its
// grid H / upc splits into whole clusters of whole row groups.
inline bool plan_shape_ok(int hidden, int upc, int ncl, int rgroups, int kc) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  const bool pow2 = (upc == 1 || upc == 2 || upc == 4 || upc == 8) &&
                    (ncl == 1 || ncl == 2 || ncl == 4 || ncl == 8) &&
                    (rgroups == 1 || rgroups == 2 || rgroups == 4);
  return pow2 && kc >= 1 && hidden % upc == 0 && hidden / upc <= sms &&
         (hidden / upc) % (ncl * rgroups) == 0;
}

// A 2-layer core's flags: the lead set's kPairSetFlags words, then the
// follow set's (each <= 4 row groups of kFlagsPerGroup).
constexpr int kPairSetFlags = 4 * kFlagsPerGroup;

// Layer l's pointer of a pair, by a select (a kernel parameter array
// indexed at run time would be copied to local memory).
template <class P>
__device__ __forceinline__ P of_layer(P const (&v)[2], int layer) {
  return layer != 0 ? v[1] : v[0];
}

// The float4 columns [*p0, *p1) of segment seg (0: the layer's own row, 1:
// the feed) in the share [lo, hi) of a 2-layer core's row, whose own part
// is own4 columns wide; the lead set's row has no feed.
__device__ __forceinline__ void pair_piece(int seg, bool follow, int lo, int hi,
                                           int own4, int* p0, int* p1) {
  if (!follow) {
    *p0 = seg == 0 ? lo : 0;
    *p1 = seg == 0 ? hi : 0;
  } else {
    *p0 = seg == 0 ? lo : max(lo, own4);
    *p1 = seg == 0 ? min(hi, own4) : hi;
  }
}

// Bit r of has_seg[seg]: rank r of a cluster of ncl holds a piece of
// segment seg of the set's row, n4 float4 columns split as share(r).
__device__ __forceinline__ void pair_ranks(bool follow, int n4, int ncl, int own4,
                                           unsigned (&has_seg)[2]) {
  has_seg[0] = has_seg[1] = 0u;
  for (int r = 0; r < ncl; ++r) {
#pragma unroll
    for (int seg = 0; seg < 2; ++seg) {
      int p0, p1;
      pair_piece(seg, follow, r * n4 / ncl, (r + 1) * n4 / ncl, own4, &p0, &p1);
      if (p0 < p1) has_seg[seg] |= 1u << r;
    }
  }
}

// The same for a 2-layer plan (rnn2_bwd_chain.cuh, rnn2_fwd_chain.cuh):
// two sets of H / upc CTAs, both within the card, each set's row groups
// within their flag blocks.
inline bool pair_plan_ok(int hidden, int upc, int ncl, int rgroups, int kc) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  return upc >= 1 && hidden % upc == 0 && 2 * (hidden / upc) <= sms &&
         hidden / upc / rgroups <= kFlagsPerGroup &&
         plan_shape_ok(hidden, upc, ncl, rgroups, kc);
}

inline const char* error_string(int err, const char* unsupported) {
  if (err == kUnsupported) return unsupported;
  if (err == kPlanMismatch) return "launch plan does not fit this shape or card";
  if (err == kNotResident) return "the grid's clusters cannot all be resident at once";
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace rnn_chain
