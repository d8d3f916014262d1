// Single-core CPU re-measurement of the reference's criterion bench bodies
// (reference benches/benches.rs:1-424); its rows are in
// benches/results_reference_cpu.jsonl.
//
// The image has no Rust toolchain, so the Rust criterion suite cannot run;
// this is a faithful C++17 -O3 re-implementation of the same op bodies on
// the same sizes (interleaved complex<float>, single thread). The FFT is an
// iterative radix-2 Cooley-Tukey (rustfft would be faster). Timing: best-of-R medians of K-iteration
// loops, reported as ns/op like criterion.
//
// Build/run:  g++ -O3 -std=c++17 -march=native benches/reference_cpu.cpp \
//             -o build/reference_cpu && ./build/reference_cpu

#include <algorithm>
#include <chrono>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <random>
#include <vector>

using cf32 = std::complex<float>;
using clk = std::chrono::steady_clock;

static std::mt19937 g_rng(815);

static std::vector<cf32> randv(size_t n) {
  std::normal_distribution<float> d(0.f, 1.f);
  std::vector<cf32> v(n);
  for (auto& x : v) x = {d(g_rng), d(g_rng)};
  return v;
}

template <typename F>
static double time_ns(F&& body, int iters_hint = 0) {
  // pick iteration count so one sample is ~2-10 ms, then median of 9
  int k = iters_hint;
  if (!k) {
    k = 1;
    for (;;) {
      auto t0 = clk::now();
      for (int i = 0; i < k; i++) body();
      double ns = std::chrono::duration<double, std::nano>(clk::now() - t0).count();
      if (ns > 2e6 || k > (1 << 22)) break;
      k *= 4;
    }
  }
  std::vector<double> samples;
  for (int r = 0; r < 9; r++) {
    auto t0 = clk::now();
    for (int i = 0; i < k; i++) body();
    samples.push_back(
        std::chrono::duration<double, std::nano>(clk::now() - t0).count() / k);
  }
  std::sort(samples.begin(), samples.end());
  return samples[samples.size() / 2];
}

static void report(const char* name, double ns, double nsamples) {
  std::printf(
      "{\"bench\": \"%s\", \"ns_per_op\": %.1f, \"msamples_per_s\": %.1f}\n",
      name, ns, nsamples / ns * 1e3);
  std::fflush(stdout);
}

// ---- vecops (benches.rs:28-70) --------------------------------------------
static void bench_vecops() {
  const size_t n = 2048;
  auto a = randv(n), b = randv(n);
  auto c = randv(n);
  // manual formula (Rust num-complex semantics): std::complex operator*
  // routes through __mulsc3's NaN-recovery, which is not what the
  // reference measures; out-of-place so magnitudes can't blow up across
  // timing iterations
  report("vecops mul 2048", time_ns([&] {
           for (size_t i = 0; i < n; i++) {
             float re = a[i].real() * b[i].real() - a[i].imag() * b[i].imag();
             float im = a[i].real() * b[i].imag() + a[i].imag() * b[i].real();
             c[i] = {re, im};
           }
         }),
         n);
  asm volatile("" : : "r"(c.data()) : "memory");
  report("vecops clone 2048", time_ns([&] {
           std::copy(b.begin(), b.end(), a.begin());
         }),
         n);
  report("vecops scale 2048", time_ns([&] {
           for (size_t i = 0; i < n; i++) a[i] *= 2.0f;
         }),
         n);
}

// ---- interpolate / downsample (benches.rs:72-133, sampling.rs) ------------
static void interpolate(const std::vector<cf32>& src, std::vector<cf32>& dst,
                        size_t n_between) {
  dst.clear();
  float step = 1.0f / (n_between + 1);
  for (size_t i = 0; i + 1 < src.size(); i++) {
    cf32 x1 = src[i], rate = (src[i + 1] - x1) * step;
    for (size_t j = 0; j <= n_between; j++)
      dst.push_back(x1 + rate * float(j));
  }
  dst.push_back(src.back());
}

static void bench_sampling() {
  std::vector<cf32> dst;
  for (auto [n, between] : {std::pair<size_t, size_t>{1024, 4}, {2048, 4}, {400, 3}}) {
    auto src = randv(n);
    dst.reserve(n * (between + 1));
    char name[64];
    std::snprintf(name, sizeof name, "interpolate (%zu,%zu)", n, between);
    report(name, time_ns([&] { interpolate(src, dst, between); }),
           double(n + (n - 1) * between));
  }
  for (auto [in, out] : {std::pair<size_t, size_t>{30720, 1024}, {8096, 512}}) {
    auto src = randv(in);
    std::vector<cf32> d(out);
    size_t step = in / out;
    char name[64];
    std::snprintf(name, sizeof name, "downsample %zu->%zu", in, out);
    report(name, time_ns([&] {
             for (size_t i = 0; i < out; i++) d[i] = src[i * step];
           }),
           double(in));
  }
}

// ---- modulation (benches.rs:192-281, modulation.rs) -----------------------
static const cf32 QPSK_TABLE[4] = {{1, 1}, {-1, 1}, {1, -1}, {-1, -1}};
static const cf32 BPSK_TABLE[2] = {{1, 1}, {-1, -1}};

static void bench_modulation() {
  const size_t nbits = 8000;
  std::uniform_int_distribution<int> bit(0, 1);
  std::vector<uint8_t> bits(nbits);
  for (auto& b : bits) b = (uint8_t)bit(g_rng);
  std::vector<cf32> syms(nbits / 2);
  report("qpsk modulate 8000 bits", time_ns([&] {
           for (size_t i = 0; i < nbits; i += 2)
             syms[i / 2] = QPSK_TABLE[bits[i] | (bits[i + 1] << 1)];
         }),
         double(nbits));
  std::vector<cf32> bsyms(nbits);
  report("bpsk modulate 8000 bits", time_ns([&] {
           for (size_t i = 0; i < nbits; i++) bsyms[i] = BPSK_TABLE[bits[i]];
         }),
         double(nbits));
  // hard nearest-neighbour demod (blanket form, modulation.rs:133-144)
  std::vector<uint8_t> out(nbits);
  report("qpsk demod 4000 syms", time_ns([&] {
           for (size_t i = 0; i < syms.size(); i++) {
             float best = 1e30f;
             int idx = 0;
             for (int c = 0; c < 4; c++) {
               float d = std::norm(syms[i] - QPSK_TABLE[c]);
               if (d < best) { best = d; idx = c; }
             }
             out[2 * i] = idx & 1;
             out[2 * i + 1] = (idx >> 1) & 1;
           }
         }),
         double(syms.size()));
}

// ---- FFT (radix-2 iterative; benches.rs:288-380) --------------------------
static void fft_inplace(std::vector<cf32>& a, int sign) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; i++) {  // bit reversal
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = sign * 2.0 * M_PI / double(len);
    cf32 wl((float)std::cos(ang), (float)std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cf32 w(1.f, 0.f);
      for (size_t j = 0; j < len / 2; j++) {
        cf32 u = a[i + j], v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wl;
      }
    }
  }
}

static void bench_fft() {
  for (size_t n : {512, 1024, 2048}) {
    auto src = randv(n);
    auto work = src;
    char name[64];
    std::snprintf(name, sizeof name, "fft %zu fwd (radix2)", n);
    report(name, time_ns([&] {
             work = src;  // copy like Cfft::fwd preserves input
             fft_inplace(work, -1);
           }),
           double(n));
    std::snprintf(name, sizeof name, "fft %zu bwd (radix2)", n);
    report(name, time_ns([&] {
             work = src;
             fft_inplace(work, +1);
           }),
           double(n));
  }
}

// ---- freq-domain correlator (benches.rs:382-423) --------------------------
static void bench_correlator() {
  for (size_t n : {512, 1024, 2048}) {
    auto sig = randv(n);
    auto ref = randv(n);
    for (auto& r : ref) r = std::conj(r);
    auto work = sig;
    char name[64];
    std::snprintf(name, sizeof name, "correlator %zu (fft-mul-ifft)", n);
    report(name, time_ns([&] {
             work = sig;
             fft_inplace(work, -1);
             for (size_t i = 0; i < n; i++) work[i] *= ref[i];
             fft_inplace(work, +1);
           }),
           double(n));
  }
}

int main() {
  std::printf("{\"suite\": \"reference-cpu-anchor\", \"impl\": \"C++17 -O3\", "
              "\"note\": \"Rust toolchain unavailable; radix-2 FFT stands in "
              "for rustfft\"}\n");
  bench_vecops();
  bench_sampling();
  bench_modulation();
  bench_fft();
  bench_correlator();
  return 0;
}
