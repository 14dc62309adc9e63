// ttx_runtime — native CPU helpers for the data and evaluation pipeline
// (the port's copy of the repo-root csrc/ttx_runtime.cc: the same four entry
// points and contracts).
//
// The reference's host-side hot loops are edit-distance CER (reference:
// editdistance package, tt/utils.py:46-50) and WAV decode (tt/utils.py:
// 168-177); the log-mel featurizer below is the frame-parallel twin of
// ops/features_np.py.  Exposed through a plain C ABI for ctypes.
//
// One difference from the root source: the log-mel's frames are split
// between std::threads, not an OpenMP team, since the card's machine has a
// g++ without libgomp ("cannot read spec file libgomp.spec").  Each frame's
// arithmetic is the root source's, so the output is the same to the bit.
//
// Build: runtime/native.py compiles it at first use with
//   g++ -O3 -std=c++17 -fPIC -Wall -pthread -shared
// into build/ttx_runtime/ at the root of the checkout.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <system_error>
#include <thread>
#include <vector>

extern "C" {

// Levenshtein distance between two int32 sequences.
int64_t ttx_levenshtein(const int32_t* a, int64_t n, const int32_t* b,
                        int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Batch edit distance: sequences are concatenated, with per-sequence offsets
// (len k+1, offsets[k] = end). Returns total distance; *total_ref_len gets
// the summed reference lengths (CER denominator).
int64_t ttx_batch_levenshtein(const int32_t* preds, const int64_t* pred_off,
                              const int32_t* refs, const int64_t* ref_off,
                              int64_t batch, int64_t* total_ref_len) {
  int64_t dist = 0, total = 0;
  for (int64_t i = 0; i < batch; ++i) {
    const int64_t pn = pred_off[i + 1] - pred_off[i];
    const int64_t rn = ref_off[i + 1] - ref_off[i];
    dist += ttx_levenshtein(preds + pred_off[i], pn, refs + ref_off[i], rn);
    total += rn;
  }
  if (total_ref_len) *total_ref_len = total;
  return dist;
}

// Minimal RIFF/WAVE PCM16 parser. Returns the number of mono samples written
// into `out` (caller allocates out_capacity int16s; channels are collapsed to
// the first channel), or -1 on parse error. `*sample_rate` receives the rate.
int64_t ttx_parse_wav(const uint8_t* data, int64_t size, int16_t* out,
                      int64_t out_capacity, int32_t* sample_rate) {
  if (size < 44 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int16_t channels = 1;
  int16_t bits = 16;
  int32_t rate = 0;
  while (pos + 8 <= size) {
    const char* tag = reinterpret_cast<const char*>(data + pos);
    uint32_t chunk = 0;
    std::memcpy(&chunk, data + pos + 4, 4);
    if (!std::memcmp(tag, "fmt ", 4)) {
      // bounds-check the fmt fields (a truncated chunk must not read past
      // the buffer) and reject degenerate headers (channels == 0 would be
      // a division by zero below — SIGFPE kills the host process)
      if (chunk < 16 || pos + 8 + 16 > size) return -1;
      std::memcpy(&channels, data + pos + 10, 2);
      std::memcpy(&rate, data + pos + 12, 4);
      std::memcpy(&bits, data + pos + 22, 2);
      if (bits != 16 || channels <= 0) return -1;
    } else if (!std::memcmp(tag, "data", 4)) {
      const int64_t n_frames = chunk / (2 * channels);
      const int64_t n = std::min(n_frames, out_capacity);
      const uint8_t* p = data + pos + 8;
      if (pos + 8 + (int64_t)chunk > size) return -1;
      for (int64_t f = 0; f < n; ++f)
        std::memcpy(out + f, p + f * 2 * channels, 2);
      if (sample_rate) *sample_rate = rate;
      return n;
    }
    pos += 8 + chunk + (chunk & 1);
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Native log-mel featurizer — GIL-free, frame-parallel (threads) twin of
// ops/features_np.py::logmel_masked / logmel_eps (which themselves mirror the
// reference's librosa pipeline, tt/utils.py:180-205): int16 wav -> f32 ->
// reflect-pad n_fft/2 -> f64 frames x periodic Hann -> rFFT -> power ->
// mel matmul -> log variant.  The mel filterbank is PASSED IN (row-major
// (n_mels, n_fft/2+1) float32, from features_np.mel_filterbank) so the
// Slaney math lives in exactly one place.

namespace {

// Iterative radix-2 complex FFT, in-place, n a power of two.
void fft_inplace(double* re, double* im, int n) {
  for (int i = 1, j = 0; i < n; ++i) {  // bit reversal
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) { std::swap(re[i], re[j]); std::swap(im[i], im[j]); }
  }
  for (int len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * 3.141592653589793238462643383279502884 / len;
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (int k = 0; k < len / 2; ++k) {
        const int a = i + k, b = i + k + len / 2;
        const double tr = re[b] * cr - im[b] * ci;
        const double ti = re[b] * ci + im[b] * cr;
        re[b] = re[a] - tr; im[b] = im[a] - ti;
        re[a] += tr;        im[a] += ti;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr; cr = ncr;
      }
    }
  }
}

// Threads for n_frames frames: OMP_NUM_THREADS if set (as the root
// source's OpenMP build reads it), else the cores; at least 16 frames each.
int64_t worker_count(int64_t n_frames) {
  int64_t n = (int64_t)std::thread::hardware_concurrency();
  if (const char* env = std::getenv("OMP_NUM_THREADS")) {
    const long v = std::strtol(env, nullptr, 10);
    if (v > 0) n = v;
  }
  return std::max<int64_t>(1, std::min<int64_t>(n, (n_frames + 15) / 16));
}

}  // namespace

// variant: 0 = masked (ln of positive mel bins, else 0; streaming apps),
//          1 = eps (log10, zeros floored to DBL_EPSILON; training dataset).
// Returns the number of frames written, or -1 (bad args / out too small).
int64_t ttx_logmel(const int16_t* wav, int64_t n, const float* mel,
                   int32_t n_mels, int32_t n_fft, int32_t hop,
                   int32_t variant, float* out, int64_t out_capacity) {
  if (n <= 0 || n_fft <= 0 || hop <= 0 || (n_fft & (n_fft - 1)) != 0)
    return -1;
  const int64_t pad = n_fft / 2;
  if (n < pad + 1) return -1;  // reflect pad needs n > n_fft/2
  const int64_t n_frames = 1 + n / hop;
  if (n_frames * n_mels > out_capacity) return -1;
  const int n_bins = n_fft / 2 + 1;

  // padded signal (f32 cast first, like the numpy pipeline)
  std::vector<double> sig(n + 2 * pad);
  for (int64_t i = 0; i < n; ++i) sig[pad + i] = (float)wav[i];
  for (int64_t i = 0; i < pad; ++i) {
    sig[pad - 1 - i] = (float)wav[i + 1];          // left reflect
    sig[n + pad + i] = (float)wav[n - 2 - i];      // right reflect
  }
  std::vector<double> window(n_fft);  // periodic Hann
  for (int i = 0; i < n_fft; ++i)
    window[i] = 0.5 - 0.5 * std::cos(2.0 * 3.141592653589793238462643383279502884 * i / n_fft);

  // frames [f0, f1): the root source's loop body, frame by frame
  auto frames = [&](int64_t f0, int64_t f1) {
    std::vector<double> re(n_fft), im(n_fft), power(n_bins);
    for (int64_t f = f0; f < f1; ++f) {
      const double* src = sig.data() + f * hop;
      for (int i = 0; i < n_fft; ++i) { re[i] = src[i] * window[i]; im[i] = 0.0; }
      fft_inplace(re.data(), im.data(), n_fft);
      for (int b = 0; b < n_bins; ++b)
        power[b] = re[b] * re[b] + im[b] * im[b];
      float* dst = out + f * n_mels;
      for (int m = 0; m < n_mels; ++m) {
        const float* w = mel + (int64_t)m * n_bins;
        double acc = 0.0;
        for (int b = 0; b < n_bins; ++b) acc += power[b] * (double)w[b];
        if (variant == 0) {
          dst[m] = acc > 0.0 ? (float)std::log(acc) : 0.0f;
        } else {
          if (acc == 0.0) acc = 2.220446049250313e-16;  // DBL_EPSILON
          dst[m] = (float)std::log10(acc);
        }
      }
    }
  };
  // contiguous blocks, one a thread; this thread takes the first, and a
  // block whose thread cannot start runs here too
  const int64_t workers = worker_count(n_frames);
  const int64_t per = (n_frames + workers - 1) / workers;
  std::vector<std::thread> pool;
  for (int64_t f0 = per; f0 < n_frames; f0 += per) {
    const int64_t f1 = std::min(n_frames, f0 + per);
    try {
      pool.emplace_back(frames, f0, f1);
    } catch (const std::system_error&) {
      frames(f0, f1);
    }
  }
  frames(0, std::min(per, n_frames));
  for (auto& t : pool) t.join();
  return n_frames;
}

}  // extern "C"
