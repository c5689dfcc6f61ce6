// Native YIN F0 extraction (OpenMP over frames).
//
// Copy of music_generation_tpu/runtime/native/yin.cc: the algorithmic twin
// of audio/f0.py yin_f0 (de Cheveigné & Kawahara 2002): difference
// function over a frame_length/2 correlation window, cumulative-mean normalization, absolute threshold with dip-run
// argmin refinement and parabolic interpolation. The numpy version
// computes the correlation via FFT; here it is direct summation in double,
// restricted to the searched lag range [1, tau_max] — O(w * tau_max) per
// frame instead of O(frame_length log frame_length), and frames parallelize
// across cores. Used by train/dataset.py preprocessing (the host-side hot
// loop when packing real corpora); the reference's equivalent preprocessing
// leaned on librosa/parselmouth (VISinger/utils, absent here by design).
// Host code, built with g++ by runtime/native_loader.py.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" void yin_f0_c(const float* wav, int64_t n, int sr, int hop,
                         int frame_length, float fmin, float fmax,
                         float threshold, float* out, int64_t n_frames) {
  const int w = frame_length / 2;
  const int tau_min = std::max(int(sr / fmax), 1);
  const int tau_max = std::min(int(std::ceil(sr / double(fmin))), w - 1);
  const int pad = frame_length / 2;
  // x = pad(wav, (pad, pad + frame_length)) — same layout as the numpy twin
  std::vector<double> x(size_t(n) + pad + pad + frame_length, 0.0);
  for (int64_t i = 0; i < n; ++i) x[pad + i] = wav[i];

#pragma omp parallel
  {
    std::vector<double> d(tau_max + 1), cmndf(tau_max + 1);
#pragma omp for schedule(static)
    for (int64_t f = 0; f < n_frames; ++f) {
      const double* fr = x.data() + f * hop;
      double e0 = 0.0;
      for (int j = 0; j < w; ++j) e0 += fr[j] * fr[j];
      // d(tau) = e0 + e_tau - 2 r(tau); e_tau tracked incrementally
      double e_tau = e0;
      d[0] = 0.0;
      for (int tau = 1; tau <= tau_max; ++tau) {
        e_tau += fr[tau - 1 + w] * fr[tau - 1 + w] -
                 fr[tau - 1] * fr[tau - 1];
        double r = 0.0;
        const double* a = fr;
        const double* b = fr + tau;
        for (int j = 0; j < w; ++j) r += a[j] * b[j];
        d[tau] = std::max(e0 + e_tau - 2.0 * r, 0.0);
      }
      // cumulative-mean normalized difference
      cmndf[0] = 1.0;
      double csum = 0.0;
      for (int tau = 1; tau <= tau_max; ++tau) {
        csum += d[tau];
        cmndf[tau] = d[tau] * tau / std::max(csum, 1e-12);
      }
      // absolute threshold over [tau_min, tau_max): the dip is the
      // contiguous under-threshold run from the first crossing; take its
      // argmin. (A greedy walk-while-decreasing stalls on cmndf ripple and
      // reads systematically sharp — see the numpy twin.) Unvoiced: band
      // argmin.
      int first = tau_min;
      bool voiced = false;
      double best = cmndf[tau_min];
      for (int tau = tau_min; tau < tau_max; ++tau) {
        if (cmndf[tau] < threshold) {
          voiced = true;
          first = tau;
          double bestv = cmndf[tau];
          for (int t2 = tau + 1; t2 < tau_max && cmndf[t2] < threshold; ++t2)
            if (cmndf[t2] < bestv) { bestv = cmndf[t2]; first = t2; }
          break;
        }
        if (cmndf[tau] < best) { best = cmndf[tau]; first = tau; }
      }
      // parabolic interpolation (first is in [tau_min, tau_max-1], so the
      // numpy clip to [1, w-2] is a no-op and tau±1 stay in range)
      const double ym = cmndf[first - 1], y0 = cmndf[first],
                   yp = cmndf[first + 1];
      const double denom = ym + yp - 2.0 * y0;
      double shift = std::abs(denom) > 1e-12 ? 0.5 * (ym - yp) / denom : 0.0;
      shift = std::min(std::max(shift, -1.0), 1.0);
      const double tau = first + shift;

      double f0 = voiced ? sr / std::max(tau, 1e-6) : 0.0;
      if (f0 < fmin || f0 > fmax) f0 = 0.0;
      if (std::sqrt(std::max(e0 / w, 0.0)) <= 1e-4) f0 = 0.0;
      out[f] = float(f0);
    }
  }
}
