// Native host-side DSP for the serving path: kaldi fbank + resampling.
//
// Derived from the JAX package's csrc/dsp.cpp: the host runtime work the
// reference delegated to torchaudio/librosa C++ kernels, per-request
// feature extraction (kaldi-compliant log-mel fbank), polyphase resampling
// and PCM16 conversion, called through ctypes (indextts_tpu_torch/utils/
// native.py, which builds it with g++ -O3 -shared -fPIC into the port's
// build directory) beside the numpy versions in frontend/features.py and
// utils/audio.py. Three changes from that file:
// * kaldi_fbank gives the same bits as there, with the work that did not
//   change them taken out: the FFT's twiddles and bit reversal are tabled
//   once a call (the twiddles by the same recurrence), its first stage
//   works on the real parts alone (the input is real), and each mel bin
//   sums only the FFT bins where its triangle is non-zero, in the same
//   order (a zero weight adds an exact 0).
// * resample_poly designs scipy.signal.resample_poly's FIR (firwin,
//   Kaiser beta 5.0, unit DC gain, times up), so its answers are scipy's
//   to float32 rounding; that file's FIR (beta 8.555, unnormalised)
//   differs from scipy's by up to ~5e-3.
// * float_to_pcm16 converts 8 samples a step with SSE2 where the compiler
//   targets it, to the same int16 values.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>
#ifdef __SSE2__
#include <emmintrin.h>
#endif

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// iterative radix-2 complex FFT of a fixed power-of-two length n, its
// bit-reversal permutation and twiddles tabled once; each stage's twiddles come
// from the recurrence w_{k+1} = w_k * e^{-2 pi i / len} from w_0 = 1, so
// the products are those of the untabled loop
// ---------------------------------------------------------------------------
struct Fft {
  std::vector<int> rev;  // i's bit-reversed index
  std::vector<double> tw_re, tw_im;  // stage len's k-th twiddle at len/2 - 1 + k

  explicit Fft(size_t n) : rev(n, 0), tw_re(n > 1 ? n - 1 : 0), tw_im(n > 1 ? n - 1 : 0) {
    for (size_t i = 1, j = 0; i < n; ++i) {
      size_t bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      rev[i] = static_cast<int>(j);
    }
    for (size_t len = 2; len <= n; len <<= 1) {
      const double ang = -2.0 * kPi / static_cast<double>(len);
      const double wr = std::cos(ang), wi = std::sin(ang);
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        tw_re[len / 2 - 1 + k] = cr;
        tw_im[len / 2 - 1 + k] = ci;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }

  // the FFT of n real samples x (zero past len, im = 0): x goes straight to
  // its bit-reversed places, the first stage (twiddle 1) adds and
  // subtracts the real parts alone; the products of every other stage are
  // those of the complex loop (on im = 0 they differ only in zeros' signs)
  void real(const double* x, int len, double* __restrict__ re,
            double* __restrict__ im, size_t n) const {
    std::fill(re, re + n, 0.0);
    std::fill(im, im + n, 0.0);
    for (int i = 0; i < len; ++i) re[rev[i]] = x[i];
    for (size_t i = 0; i < n; i += 2) {
      const double a = re[i], b = re[i + 1];
      re[i] = a + b;
      re[i + 1] = a - b;
    }
    for (size_t len2 = 4; len2 <= n; len2 <<= 1) {
      const size_t half = len2 / 2;
      const double* __restrict__ twr = tw_re.data() + half - 1;
      const double* __restrict__ twi = tw_im.data() + half - 1;
      for (size_t i = 0; i < n; i += len2) {
        double* __restrict__ ar = re + i;
        double* __restrict__ ai = im + i;
        double* __restrict__ br = re + i + half;
        double* __restrict__ bi = im + i + half;
        for (size_t k = 0; k < half; ++k) {
          const double cr = twr[k], ci = twi[k];
          const double tr = br[k] * cr - bi[k] * ci;
          const double ti = br[k] * ci + bi[k] * cr;
          br[k] = ar[k] - tr;
          bi[k] = ai[k] - ti;
          ar[k] += tr;
          ai[k] += ti;
        }
      }
    }
  }
};

double hz_to_mel_kaldi(double f) { return 1127.0 * std::log(1.0 + f / 700.0); }

double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-17 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Kaldi-style mel filterbank (matches frontend/features.py kaldi_mel_filters):
// out: (n_freqs, num_bins) row-major.
void kaldi_mel_filters(int num_bins, int fft_length, int sample_rate,
                       double low_freq, double high_freq, float* out) {
  const int n_freqs = fft_length / 2 + 1;
  const double low_mel = hz_to_mel_kaldi(low_freq);
  const double high_mel = hz_to_mel_kaldi(high_freq);
  std::vector<double> mel_points(num_bins + 2);
  for (int i = 0; i < num_bins + 2; ++i)
    mel_points[i] = low_mel + (high_mel - low_mel) * i / (num_bins + 1);
  const double bin_width = static_cast<double>(sample_rate) / fft_length;
  for (int f = 0; f < n_freqs; ++f) {
    const double mel = hz_to_mel_kaldi(bin_width * f);
    for (int b = 0; b < num_bins; ++b) {
      const double left = mel_points[b], center = mel_points[b + 1],
                   right = mel_points[b + 2];
      double w = 0.0;
      const double up = (mel - left) / (center - left);
      const double down = (right - mel) / (right - center);
      w = up < down ? up : down;
      out[f * num_bins + b] = static_cast<float>(w > 0.0 ? w : 0.0);
    }
  }
}

// Kaldi fbank core (matches frontend/features.py kaldi_fbank_core):
// snip-edges framing, per-frame DC removal, preemphasis (edge-replicated),
// povey window, power spectrum, mel projection, log with floor.
// wav: (n,) float; out: (num_frames, num_bins) row-major float32.
// Returns the number of frames written.
int kaldi_fbank(const float* wav, int64_t n, int num_bins, int sample_rate,
                int frame_length, int hop, int fft_length, double preemph,
                double low_freq, double high_freq, double mel_floor,
                float* out) {
  if (n < frame_length) return 0;
  const int num_frames = 1 + static_cast<int>((n - frame_length) / hop);
  const int n_freqs = fft_length / 2 + 1;

  // povey window
  std::vector<double> window(frame_length);
  for (int i = 0; i < frame_length; ++i) {
    const double h = 0.5 - 0.5 * std::cos(2.0 * kPi * i / (frame_length - 1));
    window[i] = std::pow(h, 0.85);
  }
  std::vector<float> filters(static_cast<size_t>(n_freqs) * num_bins);
  kaldi_mel_filters(num_bins, fft_length, sample_rate, low_freq, high_freq,
                    filters.data());
  // each bin's non-zero run of FFT bins [lo, hi), its weights bin-major
  std::vector<int> lo(num_bins), hi(num_bins), at(num_bins);
  std::vector<float> weights;
  for (int b = 0; b < num_bins; ++b) {
    lo[b] = n_freqs;
    hi[b] = 0;
    for (int f = 0; f < n_freqs; ++f) {
      if (filters[static_cast<size_t>(f) * num_bins + b] != 0.0f) {
        if (lo[b] == n_freqs) lo[b] = f;
        hi[b] = f + 1;
      }
    }
    at[b] = static_cast<int>(weights.size());
    for (int f = lo[b]; f < hi[b]; ++f)
      weights.push_back(filters[static_cast<size_t>(f) * num_bins + b]);
  }
  const Fft fft(fft_length);

  std::vector<double> frame(frame_length), re(fft_length), im(fft_length);
  std::vector<double> power(n_freqs);
  for (int t = 0; t < num_frames; ++t) {
    const float* src = wav + static_cast<int64_t>(t) * hop;
    double mean = 0.0;
    for (int i = 0; i < frame_length; ++i) mean += src[i];
    mean /= frame_length;
    for (int i = 0; i < frame_length; ++i) frame[i] = src[i] - mean;
    // preemphasis with first-sample replication
    for (int i = frame_length - 1; i > 0; --i)
      frame[i] -= preemph * frame[i - 1];
    frame[0] -= preemph * frame[0];
    for (int i = 0; i < frame_length; ++i) frame[i] *= window[i];

    fft.real(frame.data(), frame_length, re.data(), im.data(), fft_length);
    for (int f = 0; f < n_freqs; ++f) power[f] = re[f] * re[f] + im[f] * im[f];

    for (int b = 0; b < num_bins; ++b) {
      double acc = 0.0;
      const float* w = weights.data() + at[b] - lo[b];
      for (int f = lo[b]; f < hi[b]; ++f) acc += power[f] * w[f];
      if (acc < mel_floor) acc = mel_floor;
      out[static_cast<size_t>(t) * num_bins + b] =
          static_cast<float>(std::log(acc));
    }
  }
  return num_frames;
}

// Polyphase resampler with scipy.signal.resample_poly's FIR and alignment:
// firwin(2 * 10 * max(up, down) + 1, 1 / max(up, down), Kaiser beta 5.0)
// scaled to unit DC gain, times up; zero-padded ends; output sample m is
// the filter centred on upsampled index m * down. in: (n,), out buffer
// sized ceil(n * up / down). Returns the output length.
int64_t resample_poly(const float* in, int64_t n, int up, int down,
                      float* out) {
  const int max_rate = up > down ? up : down;
  const int mid = 10 * max_rate;
  const int taps = 2 * mid + 1;
  const double cutoff = 1.0 / max_rate;
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  std::vector<double> h(taps);
  double sum = 0.0;
  for (int i = 0; i < taps; ++i) {
    const double t = i - mid;
    const double sinc =
        t == 0.0 ? cutoff : std::sin(kPi * cutoff * t) / (kPi * t);
    const double r = 2.0 * i / (taps - 1) - 1.0;
    const double rr = 1.0 - r * r;
    h[i] = sinc * bessel_i0(beta * std::sqrt(rr > 0.0 ? rr : 0.0)) / i0b;
    sum += h[i];
  }
  for (int i = 0; i < taps; ++i) h[i] *= up / sum;
  const int64_t out_len = (n * up + down - 1) / down;
  for (int64_t m = 0; m < out_len; ++m) {
    // x_up[j] = in[j / up] where j % up == 0; the taps h[j - j_lo]
    const int64_t j_lo = m * down - mid;
    // the first input index k with k * up >= j_lo, and k >= 0
    int64_t k = j_lo >= 0 ? (j_lo + up - 1) / up : -((-j_lo) / up);
    if (k < 0) k = 0;
    double acc = 0.0;
    for (int64_t tap = k * up - j_lo; tap < taps && k < n; tap += up, ++k)
      acc += in[k] * h[tap];
    out[m] = static_cast<float>(acc);
  }
  return out_len;
}

// int16 PCM -> float32 [-1, 1]
void pcm16_to_float(const int16_t* in, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] / 32768.0f;
}

// float32 -> int16 with clamp (reference: wav = clamp(32767*wav, ±32767)),
// truncated toward zero. With SSE2, 8 samples a step: min/max clamp,
// cvttps2dq truncates, and packssdw narrows exactly (the values are
// within int16 already); the scalar loop does the rest.
void float_to_pcm16(const float* in, int64_t n, int16_t* out) {
  int64_t i = 0;
#ifdef __SSE2__
  const __m128 hi = _mm_set1_ps(32767.0f), lo = _mm_set1_ps(-32767.0f);
  for (; i + 8 <= n; i += 8) {
    const __m128 a = _mm_max_ps(_mm_min_ps(_mm_mul_ps(_mm_loadu_ps(in + i), hi), hi), lo);
    const __m128 b = _mm_max_ps(_mm_min_ps(_mm_mul_ps(_mm_loadu_ps(in + i + 4), hi), hi), lo);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i),
                     _mm_packs_epi32(_mm_cvttps_epi32(a), _mm_cvttps_epi32(b)));
  }
#endif
  for (; i < n; ++i) {
    float v = in[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32767.0f) v = -32767.0f;
    out[i] = static_cast<int16_t>(v);
  }
}

}  // extern "C"
