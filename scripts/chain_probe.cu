// Probes of the H100 features the one-layer reverse chains are built from
// (scripts/chain_ab.py --probe): the cost of a grid barrier, the rate at
// which every SM can read one shared block of L2, the rate of distributed
// shared memory reads inside a thread-block cluster, how many clusters of
// each size the card holds at once, whether a cooperative launch takes a
// cluster dimension, and the chain's exchange alone (write, barrier,
// read).  Plain C interface, loaded with ctypes.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libchain_probe.so scripts/chain_probe.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) grid_sync_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

// a monotonic arrival counter: step i waits until i * gridDim.x arrived
__global__ void __launch_bounds__(NT) counter_sync_kernel(unsigned* ctr,
                                                           int iters) {
  for (int i = 1; i <= iters; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr)
                   : "memory");
      const unsigned target = (unsigned)i * gridDim.x;
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v)
                     : "l"(ctr)
                     : "memory");
      } while (v < target);
    }
    __syncthreads();
  }
}

// every CTA reads the same n4 float4s from L2, reps times
__global__ void __launch_bounds__(NT) l2_shared_read_kernel(
    const float4* src, int n4, int reps, float* out) {
  float s = 0.0f;
  for (int r = 0; r < reps; ++r) {
    for (int i0 = threadIdx.x; i0 < n4; i0 += NT * 8) {
      float4 v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int i = i0 + NT * l;
        v[l] = i < n4 ? __ldcg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int l = 0; l < 8; ++l) s += v[l].x + v[l].y + v[l].z + v[l].w;
    }
  }
  if (s == 1.5e-38f) out[blockIdx.x] = s;
}

// every CTA of a cluster reads the whole share (n4 float4s) of every
// other CTA of its cluster, reps times
__global__ void __launch_bounds__(NT) dsmem_read_kernel(int n4, int reps,
                                                         float* out) {
  extern __shared__ __align__(16) float4 buf[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < n4; i += NT) {
    buf[i] = make_float4(1.f, 2.f, 3.f, (float)blockIdx.x);
  }
  cluster.sync();
  const int n = cluster.num_blocks(), me = cluster.block_rank();
  float s = 0.0f;
  for (int r = 0; r < reps; ++r) {
    for (int p = 1; p < n; ++p) {
      const float4* peer = cluster.map_shared_rank(buf, (me + p) % n);
      for (int i0 = threadIdx.x; i0 < n4; i0 += NT * 8) {
        float4 v[8];
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const int i = i0 + NT * l;
          v[l] = i < n4 ? peer[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int l = 0; l < 8; ++l) s += v[l].x + v[l].y + v[l].z + v[l].w;
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer reads its shared memory
  if (s == 1.5e-38f) out[blockIdx.x] = s;
}

// the reverse chain's exchange without its arithmetic: each step every
// CTA writes its part4 float4s of a shared block (when `write`), arrives
// at a counter barrier and waits, then reads read4 float4s of the block
// (8 in flight a thread)
__global__ void __launch_bounds__(NT) exchange_kernel(float4* blk,
                                                      unsigned* ctr, int steps,
                                                      int part4, int read4,
                                                      int write, float* out) {
  const int total4 = gridDim.x * part4;
  float s = 0.0f;
  for (int q = 1; q <= steps; ++q) {
    if (write) {
      for (int i = threadIdx.x; i < part4; i += NT) {
        blk[blockIdx.x * part4 + i] = make_float4((float)q, 1.f, 2.f, 3.f);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(ctr, 1u);
      const unsigned target = (unsigned)q * gridDim.x;
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v)
                     : "l"(ctr)
                     : "memory");
      } while (v < target);
    }
    __syncthreads();
    const int base = (int)(((long long)blockIdx.x * 7919 * 64) % total4);
    for (int i0 = threadIdx.x; i0 < read4; i0 += NT * 8) {
      float4 v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int i = i0 + NT * l;
        v[l] = i < read4 ? __ldcg(blk + (base + i) % total4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int l = 0; l < 8; ++l) s += v[l].x + v[l].w;
    }
    __syncthreads();
  }
  if (s == 1.5e-38f) out[blockIdx.x] = s;
}

}  // namespace

extern "C" int chain_probe_exchange(float* blk, unsigned* ctr, int ctas,
                                    int steps, int part4, int read4,
                                    int write, float* out, void* stream) {
  void* args[] = {(void*)&blk,  (void*)&ctr,   (void*)&steps, (void*)&part4,
                  (void*)&read4, (void*)&write, (void*)&out};
  return cudaLaunchCooperativeKernel((const void*)&exchange_kernel,
                                     dim3(ctas), dim3(NT), args, 0,
                                     (cudaStream_t)stream);
}

extern "C" int chain_probe_grid_sync(int ctas, int iters, void* stream) {
  void* args[] = {(void*)&iters};
  return cudaLaunchCooperativeKernel((const void*)&grid_sync_kernel,
                                     dim3(ctas), dim3(NT), args, 0,
                                     (cudaStream_t)stream);
}

extern "C" int chain_probe_counter_sync(unsigned* ctr, int ctas, int iters,
                                        void* stream) {
  void* args[] = {(void*)&ctr, (void*)&iters};
  // cooperative: the launch is refused unless every CTA is resident
  return cudaLaunchCooperativeKernel((const void*)&counter_sync_kernel,
                                     dim3(ctas), dim3(NT), args, 0,
                                     (cudaStream_t)stream);
}

extern "C" int chain_probe_l2_read(const float* src, int n4, int ctas,
                                   int reps, float* out, void* stream) {
  l2_shared_read_kernel<<<ctas, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src), n4, reps, out);
  return cudaGetLastError();
}

extern "C" int chain_probe_dsmem_read(int cluster, int ctas, int n4, int reps,
                                      float* out, void* stream) {
  const size_t smem = (size_t)n4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)&dsmem_read_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute((const void*)&dsmem_read_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dsmem_read_kernel, n4, reps, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// how many clusters of `cluster` CTAs of NT threads and `smem` bytes the
// card holds at once (cudaOccupancyMaxActiveClusters), into *count
extern "C" int chain_probe_max_clusters(int cluster, int smem, int* count) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)&dsmem_read_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute((const void*)&dsmem_read_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, (const void*)&dsmem_read_kernel,
                                        &cfg);
}

// a cooperative launch with a cluster dimension: the error code the CUDA
// runtime returns (0 when it takes the pair)
extern "C" int chain_probe_coop_cluster(int cluster, int ctas, void* stream) {
  int iters = 4;
  void* args[] = {(void*)&iters};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NT);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t err =
      cudaLaunchKernelExC(&cfg, (const void*)&grid_sync_kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* chain_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
