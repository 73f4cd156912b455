// Log-mel spectrogram for Hopper (sm_90a), by a shared-memory FFT.
//
// Replaces: multimodal_emotion_detection_tpu/ops/logmel.py::logmel_pallas
// (kernel body _logmel_kernel).  Same function as the plain PyTorch
// version ops/logmel.py::logmel_frames:
//
//   frame  = wave[b, f*hop : f*hop + n_fft] * window     (Hann, centre-padded)
//   X      = rfft(frame)                                 (bins 0 .. n_fft / 2)
//   out    = log(|X|^2 @ mel + eps)
//
// What bounds it on the H100: bytes.  At the flagship shape (B=32, 48,000
// samples, n_fft 512, hop 128, 257 bins, 64 mels -> 372 frames) an FFT
// needs ~0.14 GFLOP (2.5 N log2 N a frame) and the filterbank's non-zeros
// ~0.01, while the waveform in and the features out are ~9 MB: ~2.8 us at
// 3.35 TB/s against ~2 us at the 67 TFLOP/s float32 rate.  The products'
// formulation the plain version uses (frames times the window-folded DFT
// basis) needs ~5.3 GFLOP, 0.079 ms at that rate.
//
// Design: a warp owns a frame, a CTA takes NW consecutive frames of the
// flattened (clip, frame) index, so the grid spreads any batch (b1's 372
// frames are 93 CTAs); the kernel is compiled for each n_fft it takes, so
// its stage loops unroll.  The n_fft real samples are packed as n_fft / 2
// complex points z[n] = x[2n] + i x[2n+1], each sample times the window as
// it is read from device memory; points outside the window's non-zero
// taps [p_lo, p_hi) are zero and not read.  Z = FFT(z) runs as Stockham
// autosort stages (radix 4, a last radix-2 stage where log2(n_fft / 2) is
// odd), natural order in and out, each butterfly in registers and each
// stage's exchange through two shared-memory buffers of the warp (one
// float2 of padding every 16, which keeps the strided stores of the first
// stages to ~1.4x the conflict-free wavefronts), __syncwarp() between
// stages.  The twiddles come from a table W_N^k = exp(-2 pi i k / N) the
// wrapper rounds from float64 (no sincos in the kernel).  The real split
// X[k] = E[k] + W_N^k O[k], E = (Z[k] + conj Z[M - k]) / 2, O = (Z[k] -
// conj Z[M - k]) / 2i gives bins 0 .. M; the power goes to shared memory
// and each lane sums the non-zero runs of a low and a high band of the
// filterbank (first bin, count, offset into the packed weights) in bin
// order: the dense product's terms without its zeros.  Neither the frames nor the spectrum
// reach device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 4;   // warps per CTA: one frame each
constexpr int NT = 32 * NW;
constexpr int MAXM = 64;  // mel bands: two a lane
constexpr int JC = 4;     // the most butterflies (or bins) a lane holds at once

// a frame buffer's float2 slot of point i: one pad slot every 16
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int buffer_slots(int m) { return m + m / 16; }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// the 4-point DFT in place (W_4 = -i)
__device__ __forceinline__ void dft4(float2 (&v)[4]) {
  const float2 s0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 d0 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 s1 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 d1 = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
  v[0] = make_float2(s0.x + s1.x, s0.y + s1.y);
  v[1] = make_float2(d0.x + d1.y, d0.y - d1.x);
  v[2] = make_float2(s0.x - s1.x, s0.y - s1.y);
  v[3] = make_float2(d0.x - d1.y, d0.y + d1.x);
}

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// M = n_fft / 2 complex points, a power of two in 32 .. 2048: the stage
// loops unroll, and a lane's JC butterflies of a stage are read into
// registers before any is written (the two buffers may alias as far as
// the compiler knows), so their loads are in flight together
template <int M>
__global__ void __launch_bounds__(NT) logmel_kernel(
    const float* __restrict__ wave,  // (B, T)
    const float2* __restrict__ tw,   // (n_fft,): W_N^k
    const float2* __restrict__ win,  // (n_fft / 2,): window taps 2n, 2n + 1
    const int4* __restrict__ runs,   // (n_mels,): first bin, count, offset
    const float* __restrict__ melw,  // the runs' weights, packed
    float* __restrict__ out,         // (B, F, n_mels)
    int t_len, int frames, int total, int p_lo, int p_hi, int hop, int n_mels,
    float eps) {
  constexpr int N = 2 * M, Q = M / 4, H = M / 2;
  constexpr int R4 = log2i(M) / 2;  // radix-4 stages; + one radix-2 if log2(M) odd
  // a lane's butterflies a radix-4 stage, a radix-2 stage, and bins of the
  // split (M = 32: lanes past Q and H idle), each taken C at a time
  constexpr int J4 = Q < 32 ? 1 : Q / 32, C4 = J4 < JC ? J4 : JC;
  constexpr int J2 = H < 32 ? 1 : H / 32, C2 = J2 < JC ? J2 : JC;
  constexpr int JS = M / 32, CS = JS < JC ? JS : JC;
  extern __shared__ float2 smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gf = blockIdx.x * NW + w;  // the frame over (B, F)
  if (gf >= total) return;             // the warp's own frame only: no CTA barrier
  const int b = gf / frames, f = gf - b * frames;
  float2* src = smem + (size_t)w * 2 * buffer_slots(M);
  float2* dst = src + buffer_slots(M);
  const float* xs = wave + (size_t)b * t_len + (size_t)f * hop;

  // radix-4 stage s (Ns = 4^s): butterfly j reads points j + r Q, the
  // first stage straight from the waveform, windowed (twiddles all 1),
  // and writes (j / Ns) 4 Ns + j % Ns + r Ns
#pragma unroll
  for (int s = 0; s < R4; ++s) {
    const int ns = 1 << (2 * s);
    const int ts = N / (4 * ns);  // W_{4 Ns}^{r k} = W_N^{r k ts}
#pragma unroll 1
    for (int c = 0; c < J4; c += C4) {
      float2 v[C4][4];
#pragma unroll
      for (int u = 0; u < C4; ++u) {
        const int j = lane + 32 * (c + u);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = j + r * Q;
          if (Q < 32 && j >= Q) {
            v[u][r] = make_float2(0.0f, 0.0f);
          } else if (s > 0) {
            v[u][r] = src[slot(p)];
          } else if (p >= p_lo && p < p_hi) {
            const float2 wn = __ldg(win + p);
            v[u][r] = make_float2(__ldg(xs + 2 * p) * wn.x, __ldg(xs + 2 * p + 1) * wn.y);
          } else {
            v[u][r] = make_float2(0.0f, 0.0f);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < C4; ++u) {
        const int j = lane + 32 * (c + u);
        if (Q < 32 && j >= Q) continue;
        const int k = j & (ns - 1);
        if (s > 0) {
#pragma unroll
          for (int r = 1; r < 4; ++r) v[u][r] = cmul(v[u][r], __ldg(tw + r * k * ts));
        }
        dft4(v[u]);
        const int d = 4 * (j - k) + k;
#pragma unroll
        for (int r = 0; r < 4; ++r) dst[slot(d + r * ns)] = v[u][r];
      }
    }
    __syncwarp();
    float2* t = src;
    src = dst;
    dst = t;
  }
  if constexpr ((log2i(M) & 1) != 0) {  // the radix-2 stage, Ns = M / 2
#pragma unroll 1
    for (int c = 0; c < J2; c += C2) {
      float2 a[C2], e[C2];
#pragma unroll
      for (int u = 0; u < C2; ++u) {
        const int j = lane + 32 * (c + u);
        if (H >= 32 || j < H) {
          a[u] = src[slot(j)];
          e[u] = src[slot(j + H)];
        }
      }
#pragma unroll
      for (int u = 0; u < C2; ++u) {
        const int j = lane + 32 * (c + u);
        if (H < 32 && j >= H) continue;
        const float2 x = cmul(e[u], __ldg(tw + 2 * j));
        dst[slot(j)] = make_float2(a[u].x + x.x, a[u].y + x.y);
        dst[slot(j + H)] = make_float2(a[u].x - x.x, a[u].y - x.y);
      }
    }
    __syncwarp();
    float2* t = src;
    src = dst;
    dst = t;
  }

  // the real split and the power of bins 0 .. M (lane 0 also takes M),
  // into the other buffer (its last reads were the last stage's, before
  // the __syncwarp)
  float* pw = reinterpret_cast<float*>(dst);
  auto power = [&](int k, float2 a, float2 c) {
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 o = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 t = cmul(o, __ldg(tw + k));
    const float xr = e.x + t.x, xi = e.y + t.y;
    pw[k] = xr * xr + xi * xi;
  };
#pragma unroll 1
  for (int c = 0; c < JS; c += CS) {
    float2 a[CS], z[CS];
#pragma unroll
    for (int u = 0; u < CS; ++u) {
      const int k = lane + 32 * (c + u);
      a[u] = src[slot(k)];
      z[u] = src[slot((M - k) & (M - 1))];
    }
#pragma unroll
    for (int u = 0; u < CS; ++u) power(lane + 32 * (c + u), a[u], z[u]);
  }
  if (lane == 0) power(M, src[0], src[0]);
  __syncwarp();

  // lane L sums bands L and n_mels - 1 - L of the lower and upper half (a
  // low band's short run beside a high band's long one), each run in bin
  // order
  float* orow = out + (size_t)gf * n_mels;
  const int half = (n_mels + 1) / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int band = h == 0 ? lane : n_mels - 1 - lane;
    if (h == 0 ? band >= half : band < half) continue;
    const int4 run = __ldg(runs + band);
    float acc = 0.0f;
    for (int i = 0; i < run.y; ++i) acc += pw[run.x + i] * __ldg(melw + run.z + i);
    orow[band] = logf(acc + eps);
  }
}

template <int M>
cudaError_t launch(const float* wave, const float* tw, const float* win, const int* runs,
                   const float* melw, float* out, int t_len, int frames, int total,
                   int p_lo, int p_hi, int hop, int n_mels, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)NW * 2 * buffer_slots(M) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((total + NW - 1) / NW);
  logmel_kernel<M><<<grid, NT, smem, stream>>>(
      wave, reinterpret_cast<const float2*>(tw), reinterpret_cast<const float2*>(win),
      reinterpret_cast<const int4*>(runs), melw, out, t_len, frames, total, p_lo, p_hi,
      hop, n_mels, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int logmel_launch(const float* wave, const float* tw, const float* win,
                             const int* runs, const float* melw, float* out,
                             int batch, int t_len, int frames, int n_fft, int p_lo,
                             int p_hi, int hop, int n_mels, float eps, void* stream) {
  const long long total = (long long)batch * frames;
  if (batch < 1 || frames < 1 || n_mels < 1 || n_mels > MAXM || hop < 1 ||
      (long long)(frames - 1) * hop + n_fft > t_len || p_lo < 0 || p_hi <= p_lo ||
      p_hi > n_fft / 2 || total > 0x7fffffffLL - NW) {
    return cudaErrorInvalidValue;
  }
  // n_fft a power of two in 64 .. 4096: the kernel for its M = n_fft / 2
  decltype(&launch<32>) run = nullptr;
  switch (n_fft) {
    case 64: run = launch<32>; break;
    case 128: run = launch<64>; break;
    case 256: run = launch<128>; break;
    case 512: run = launch<256>; break;
    case 1024: run = launch<512>; break;
    case 2048: run = launch<1024>; break;
    case 4096: run = launch<2048>; break;
    default: return cudaErrorInvalidValue;
  }
  return run(wave, tw, win, runs, melw, out, t_len, frames, (int)total, p_lo, p_hi, hop,
             n_mels, eps, (cudaStream_t)stream);
}

extern "C" const char* logmel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
