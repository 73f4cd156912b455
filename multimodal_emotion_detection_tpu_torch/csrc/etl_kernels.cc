// Native ETL kernels: polyphase FIR resampling + peak normalization.
//
// The reference's ETL hot loop leans on librosa/soxr's native resampler
// (the reference's dataprocessing.py:196, through its soxr pin); this is
// the equivalent native tier for the port's offline ETL: a
// dependency-free upfirdn core loaded through ctypes
// (multimodal_emotion_detection_tpu_torch/utils/native.py).  Its plain
// version is scipy's resample_poly, which runs only when a caller asks
// for it.  The source is a copy of the JAX package's
// native/etl_kernels.cc, so both packages' builds give the same bits.
//
// upfirdn semantics match scipy.signal.upfirdn(mode='constant', cval=0):
//   zero-stuff x by `up`, convolve with h, take every `down`-th sample.
// The Python wrapper reproduces scipy.resample_poly's filter design and
// pre/post padding so outputs agree with scipy to ~1e-12 (tested).
//
// Built on first use by utils/native.py (g++ -O3 -fPIC -shared
// -std=c++17) into build/etl_native/, a directory git ignores.

#include <cmath>
#include <cstdint>

extern "C" {

// y[m] = sum_j h[j] * x_up[m*down - j], x_up = zero-stuffed x (factor up).
// Only j with (m*down - j) % up == 0 and 0 <= (m*down - j)/up < n
// contribute.  Iterating over the input taps per phase keeps the inner
// loop dense (polyphase decomposition).
void upfirdn_f64(const double* x, int64_t n, const double* h, int64_t taps,
                 int64_t up, int64_t down, double* y, int64_t n_out) {
  for (int64_t m = 0; m < n_out; ++m) {
    const int64_t t = m * down;  // index in upsampled time
    // smallest j >= 0 with (t - j) % up == 0  ->  j0 = t % up
    double acc = 0.0;
    for (int64_t j = t % up; j < taps; j += up) {
      const int64_t k = (t - j) / up;
      if (k < 0) break;      // j > t: past the start of x
      if (k < n) acc += h[j] * x[k];
    }
    y[m] = acc;
  }
}

// Convenience float32 front: accumulate in double like scipy's float64 path.
void upfirdn_f32(const float* x, int64_t n, const double* h, int64_t taps,
                 int64_t up, int64_t down, float* y, int64_t n_out) {
  for (int64_t m = 0; m < n_out; ++m) {
    const int64_t t = m * down;
    double acc = 0.0;
    for (int64_t j = t % up; j < taps; j += up) {
      const int64_t k = (t - j) / up;
      if (k < 0) break;
      if (k < n) acc += h[j] * static_cast<double>(x[k]);
    }
    y[m] = static_cast<float>(acc);
  }
}

// In-place peak normalization: x /= max(|x|) when the peak is positive.
void peak_normalize_f32(float* x, int64_t n) {
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const float a = x[i] < 0 ? -x[i] : x[i];
    if (a > peak) peak = a;
  }
  if (peak > 0.0f) {
    const float inv = 1.0f / peak;
    for (int64_t i = 0; i < n; ++i) x[i] *= inv;
  }
}

// int16 PCM -> float32 in [-1, 1) with optional channel mixdown.
void pcm16_to_f32_mono(const int16_t* in, int64_t frames, int channels,
                       float* out) {
  const float scale = 1.0f / 32768.0f;
  if (channels == 1) {
    for (int64_t i = 0; i < frames; ++i) out[i] = in[i] * scale;
    return;
  }
  const float inv_ch = 1.0f / channels;
  for (int64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
    out[i] = acc * scale * inv_ch;
  }
}

}  // extern "C"
