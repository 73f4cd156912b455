// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces: multimodal_emotion_detection_tpu/ops/logmel.py::logmel_pallas
// (kernel body _logmel_kernel).  Same function as the plain PyTorch
// version ops/logmel.py::logmel_frames:
//
//   frames = wave[b, f*hop : f*hop + n_fft]             (framing)
//   re, im = frames @ cos_basis, frames @ sin_basis     (Hann folded in)
//   out    = log((re^2 + im^2) @ mel + eps)
//
// What bounds it on the H100: arithmetic.  At the flagship shape
// (B=32, 48,000 samples, n_fft 512, hop 128, 257 bins, 64 mels -> 372
// frames) the DFT over the window's 399 non-zero taps is 4.9 GFLOP and the
// mel product 0.4 GFLOP, while the bytes that must move are ~10 MB
// (waveform in, features out, constants): ~0.08 ms at the 67 TFLOP/s
// float32 rate against ~3 us at 3.35 TB/s.  The products stay in float32
// on the CUDA cores (no TF32 tensor cores): the reference computes them at
// full float32 precision.
//
// Design: one CTA per (clip, tile of TF frames).  The CTA copies the
// waveform span its frames cover into shared memory once and frames from
// there, so any hop works and the (B, F, n_fft) frame matrix never exists
// in device memory.  It walks the bins in tiles of BK: per tile it stages
// TK taps of the cos/sin bases in shared memory (the next chunk's float4
// loads are in flight while the current one is used) and accumulates
// re/im in registers, forms the power tile in shared memory and adds
// power_tile @ mel[bins, :] into per-thread mel accumulators that live
// across all bin tiles.  The spectrum never leaves the SM either.
//
// The window is centre-padded into n_fft (400 of 512 taps at the
// flagship), so the basis rows outside [t_lo, t_hi) are all zero: the
// caller passes that range, aligned to TK, and the DFT walks only it.
//
// The DFT's inner loop is bound by shared-memory loads, so the layout
// minimises them per FMA: a warp owns FT frames and its 32 lanes own 4
// bins each, so a tap costs a lane FT waveform loads that are broadcasts
// (all lanes read one address) and 2 float4 basis loads, for 8*FT FMAs.
// The bins past the last full tile (the Nyquist bin at n_fft 512) go
// through a narrow pass instead of a tile that would be almost all
// padding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;   // threads per CTA: 4 warps
constexpr int FT = 8;     // frames per warp: w + 4*i
constexpr int TF = (NT / 32) * FT;  // frames per CTA (32)
constexpr int BK = 128;   // bins per tile: 4 per lane
constexpr int TK = 16;    // taps per staged basis chunk
constexpr int MB = 2;     // mel bands per lane: lane + 32*j
constexpr int MAXM = 32 * MB;
constexpr int Q = TK * BK / 4 / NT;  // float4 of one basis chunk per thread
constexpr int PS = BK + 1;           // pow_s row stride

__global__ void __launch_bounds__(NT) logmel_kernel(
    const float* __restrict__ wave,   // (B, T)
    const float* __restrict__ cosb,   // (n_fft, ldb), columns >= n_bins zero
    const float* __restrict__ sinb,   // (n_fft, ldb)
    const float* __restrict__ mel,    // (n_bins, n_mels)
    float* __restrict__ out,          // (B, F, n_mels)
    int t_len, int frames, int n_fft, int t_lo, int t_hi, int hop,
    int n_bins, int ldb, int n_mels, int span_alloc, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* cos_s = smem;                // TK * BK
  float* sin_s = cos_s + TK * BK;     // TK * BK
  float* pow_s = sin_s + TK * BK;     // TF * PS
  float* wav_s = pow_s + TF * PS;     // span_alloc

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x;
  const int f0 = blockIdx.y * TF;
  const int nf = min(TF, frames - f0);

  // the frames' waveform span; beyond it zeros, so the rows of frames
  // past the last one read defined values (their results are dropped)
  const int span = (nf - 1) * hop + n_fft;
  const float* w = wave + (size_t)b * t_len + (size_t)f0 * hop;
  for (int i = tid; i < span_alloc; i += NT) wav_s[i] = i < span ? w[i] : 0.0f;

  float acc[FT][MB];
#pragma unroll
  for (int i = 0; i < FT; ++i)
#pragma unroll
    for (int j = 0; j < MB; ++j) acc[i][j] = 0.0f;

  // frames warp + 4*i, bands lane + 32*j
  auto mel_accumulate = [&](int k0, int width) {
    for (int kk = 0; kk < width; ++kk) {
      const float* mrow = mel + (size_t)(k0 + kk) * n_mels;
      float mw[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const int m = lane + 32 * j;
        mw[j] = m < n_mels ? __ldg(mrow + m) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < FT; ++i) {
        const float pw = pow_s[(warp + 4 * i) * PS + kk];
#pragma unroll
        for (int j = 0; j < MB; ++j) acc[i][j] += pw * mw[j];
      }
    }
  };

  const int nfull = n_bins / BK;
  float4 pc[Q], ps[Q];
  auto fetch = [&](int k0, int t0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = tid + q * NT;
      const size_t off =
          (size_t)(t0 + e / (BK / 4)) * ldb + k0 + 4 * (e % (BK / 4));
      pc[q] = __ldg(reinterpret_cast<const float4*>(cosb + off));
      ps[q] = __ldg(reinterpret_cast<const float4*>(sinb + off));
    }
  };
  if (nfull > 0) fetch(0, t_lo);

  for (int tile = 0; tile < nfull; ++tile) {
    const int k0 = tile * BK;
    float re[FT][4], im[FT][4];
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;

    for (int t0 = t_lo; t0 < t_hi; t0 += TK) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int e = tid + q * NT;
        reinterpret_cast<float4*>(cos_s)[e] = pc[q];
        reinterpret_cast<float4*>(sin_s)[e] = ps[q];
      }
      __syncthreads();
      // the next chunk (of this tile or the next one) while this one runs
      if (t0 + TK < t_hi) {
        fetch(k0, t0 + TK);
      } else if (tile + 1 < nfull) {
        fetch(k0 + BK, t_lo);
      }
      const float* xp = wav_s + warp * hop + t0;
#pragma unroll 2
      for (int tt = 0; tt < TK; ++tt) {
        const float4 c = *reinterpret_cast<const float4*>(cos_s + tt * BK + 4 * lane);
        const float4 s = *reinterpret_cast<const float4*>(sin_s + tt * BK + 4 * lane);
#pragma unroll
        for (int i = 0; i < FT; ++i) {
          const float x = xp[4 * i * hop + tt];  // one address per warp
          re[i][0] += x * c.x; re[i][1] += x * c.y;
          re[i][2] += x * c.z; re[i][3] += x * c.w;
          im[i][0] += x * s.x; im[i][1] += x * s.y;
          im[i][2] += x * s.z; im[i][3] += x * s.w;
        }
      }
    }

    // the t-loop's first __syncthreads() ordered the previous tile's
    // pow_s reads before these writes
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pow_s[(warp + 4 * i) * PS + 4 * lane + j] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
    __syncthreads();
    mel_accumulate(k0, BK);
  }

  // bins past the last full tile: one (frame, bin) output per thread
  const int k0 = nfull * BK;
  const int rest = n_bins - k0;
  if (rest > 0) {
    __syncthreads();
    for (int e = tid; e < TF * rest; e += NT) {
      const int f = e / rest, kk = e % rest;
      const float* xf = wav_s + f * hop;
      float re = 0.0f, im = 0.0f;
      for (int t = t_lo; t < t_hi; ++t) {
        const float x = xf[t];
        re += x * __ldg(cosb + (size_t)t * ldb + k0 + kk);
        im += x * __ldg(sinb + (size_t)t * ldb + k0 + kk);
      }
      // row f of pow_s holds frame f: warp + 4*i with warp = f % 4
      pow_s[f * PS + kk] = re * re + im * im;
    }
    __syncthreads();
    mel_accumulate(k0, rest);
  }

#pragma unroll
  for (int i = 0; i < FT; ++i) {
    const int f = warp + 4 * i;
    if (f >= nf) continue;
    float* orow = out + ((size_t)b * frames + f0 + f) * n_mels;
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels) orow[m] = logf(acc[i][j] + eps);
    }
  }
}

}  // namespace

extern "C" int logmel_launch(const float* wave, const float* cosb,
                             const float* sinb, const float* mel, float* out,
                             int batch, int t_len, int frames, int n_fft,
                             int t_lo, int t_hi, int hop, int n_bins,
                             int ldb, int n_mels, float eps, void* stream) {
  if (batch < 1 || frames < 1 || n_fft % TK != 0 || n_mels > MAXM ||
      ldb % 4 != 0 || ldb < n_bins || (frames - 1) * hop + n_fft > t_len ||
      t_lo < 0 || t_lo % TK != 0 || t_hi <= t_lo || t_hi % TK != 0 ||
      t_hi > n_fft) {
    return cudaErrorInvalidValue;
  }
  const int span_alloc = (TF - 1) * hop + n_fft;
  const size_t smem =
      (size_t)(2 * TK * BK + TF * PS + span_alloc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, (frames + TF - 1) / TF);
  logmel_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      wave, cosb, sinb, mel, out, t_len, frames, n_fft, t_lo, t_hi, hop,
      n_bins, ldb, n_mels, span_alloc, eps);
  return cudaGetLastError();
}

extern "C" const char* logmel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
