// The mma.sync TF32 rate of one card, for scripts/flash_ab.py --mma-rate:
// each warp runs `chain` x 8 independent m16n8k8 TF32 MMAs per iteration
// from registers (no memory traffic), the product flash_mma.cuh is built on.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//     -I multimodal_emotion_detection_tpu_torch/csrc -o libmma_rate.so mma_rate.cu

#include "flash_mma.cuh"

namespace {

template <int CHAIN>
__global__ void mma_rate_kernel(int iters, float* out) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAIN; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) flash_mma::mma_tf32(acc[j], a, b0 + j, b1);
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 12345.0f) out[threadIdx.x] = s;  // keeps the products live
}

}  // namespace

// chain 1: 8 independent accumulators per warp; chain 3: three MMAs in a row
// into each, as a 3xTF32 product chains them
extern "C" int mma_rate_launch(int blocks, int threads, int iters, int chain,
                               float* out, void* stream) {
  if (chain == 1)
    mma_rate_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, out);
  else
    mma_rate_kernel<3><<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, out);
  return cudaGetLastError();
}
