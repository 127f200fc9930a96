// Native host-side runtime components.
//
// The reference is 100% C++/CUDA; its host-side pieces map here:
//   * Black-Scholes oracle + A&S CND      (inc/BlackandScholes.hpp:8-43)
//   * CPU reference pricers               (inc/tool.cuh:104-173)
//   * CSV trajectory writer               (testing.cu:37-47)
// plus a native mirror of the framework's counter-based threefry RNG so the
// CPU pricers consume the SAME stream as the device kernels (the reference's
// shared-random-array fixture, inc/testing.cuh:17-42, done properly: the
// stream is a pure function, not a pre-generated array).
//
// Multithreading replaces the reference's single-threaded std::mt19937
// loops: paths are split across hardware threads, each thread Kahan-sums
// its slice, and the slices combine in long double.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Threefry2x32 (20 rounds) — bit-exact mirror of mc_tpu/rng.py.
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

static const int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};

// Arbitrary round count (mirror of rng.threefry2x32's loop): key
// injection after every 4th round.  13 rounds = the framework's
// BigCrush-minimal normal-draw default (rng.DEFAULT_ROUNDS); 20 = the
// Random123 safety-margin count used for key derivation.
void threefry2x32_r(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                    int rounds, uint32_t* out0, uint32_t* out1) {
  uint32_t ks[3] = {k0, k1, (uint32_t)(k0 ^ k1 ^ 0x1BD11BDAu)};
  x0 += k0;
  x1 += k1;
  for (int r = 0; r < rounds; ++r) {
    x0 += x1;
    x1 = rotl32(x1, kRot[r % 8]);
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {
      int inj = (r + 1) / 4;
      x0 += ks[inj % 3];
      x1 += ks[(inj + 1) % 3] + (uint32_t)inj;
    }
  }
  *out0 = x0;
  *out1 = x1;
}

void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                  uint32_t* out0, uint32_t* out1) {
  threefry2x32_r(k0, k1, x0, x1, 20, out0, out1);
}

// bits -> [0,1) float, same mantissa construction as rng.bits_to_unit.
static inline float bits_to_unit(uint32_t b) {
  uint32_t u = (b >> 9) | 0x3F800000u;
  float f;
  std::memcpy(&f, &u, 4);
  return f - 1.0f;
}

// Box-Muller pair, same formula as rng.normal_pair.
static inline void normal_pair(uint32_t k0, uint32_t k1, uint32_t c0,
                               uint32_t c1, int rounds, float* z0,
                               float* z1) {
  uint32_t b0, b1;
  threefry2x32_r(k0, k1, c0, c1, rounds, &b0, &b1);
  float u1 = bits_to_unit(b0);
  float u2 = bits_to_unit(b1);
  float rad = sqrtf(-2.0f * log1pf(-u1));
  float theta = 6.283185307179586f * u2;
  *z0 = rad * cosf(theta);
  *z1 = rad * sinf(theta);
}

// Normal draw j of path i (half j%2 of pair j/2) — the stream convention
// shared with the Pallas kernels and rng.normals.
static inline float normal_draw(uint32_t k0, uint32_t k1, uint32_t path,
                                uint32_t j, int rounds) {
  float z0, z1;
  normal_pair(k0, k1, path, j / 2, rounds, &z0, &z1);
  return (j % 2 == 0) ? z0 : z1;
}

// ---------------------------------------------------------------------------
// Black-Scholes oracle (BlackandScholes.hpp:8-43)
// ---------------------------------------------------------------------------

// Abramowitz-Stegun 5-term polynomial CND — reference parity.
double cnd_as(double x) {
  const double p = 0.2316419;
  const double b1 = 0.31938153, b2 = -0.356563782, b3 = 1.781477937,
               b4 = -1.821255978, b5 = 1.330274429;
  const double c = 0.39894228;  // 1/sqrt(2*pi), reference precision
  double ax = fabs(x);
  double t = 1.0 / (1.0 + p * ax);
  double poly = t * (b1 + t * (b2 + t * (b3 + t * (b4 + t * b5))));
  double upper = c * exp(-0.5 * ax * ax) * poly;
  return x >= 0.0 ? 1.0 - upper : upper;
}

// Exact CND via erfc.
double cnd_exact(double x) { return 0.5 * erfc(-x * M_SQRT1_2); }

double black_scholes_call(double s0, double k, double t, double r,
                          double sigma, int exact) {
  double st = sigma * sqrt(t);
  double d1 = (log(s0 / k) + (r + 0.5 * sigma * sigma) * t) / st;
  double d2 = d1 - st;
  double (*cnd)(double) = exact ? cnd_exact : cnd_as;
  return s0 * cnd(d1) - k * exp(-r * t) * cnd(d2);
}

// ---------------------------------------------------------------------------
// CPU reference pricers (tool.cuh:104-173), multithreaded.
// payoff_kind: 0 = vanilla call (terminal one-shot draw, tool.cuh:120-126)
//              1 = bullet call  (log-Euler loop + window, tool.cuh:155-171)
//              2 = vanilla call, PAIRED terminal scheme: element e carries
//                  paths (2e, 2e+1) from both Box-Muller halves of pair 0
//                  (the method="terminal_pair" stream, mirrored)
// Returns price; *stderr_out gets the standard error of the mean.
// ---------------------------------------------------------------------------

struct Moments {
  long double sum = 0.0L;
  long double sum2 = 0.0L;
};

static void price_slice(int payoff_kind, uint32_t k0, uint32_t k1,
                        uint64_t begin, uint64_t end, int n_steps, float s0,
                        float k, float r, float sigma, float t, float barrier,
                        float p1, float p2, float q, int rounds,
                        Moments* out) {
  float dt = t / (float)n_steps;
  float drift_dt = (r - q - 0.5f * sigma * sigma) * dt;
  float vol_dt = sigma * sqrtf(dt);
  float drift_t = (r - q - 0.5f * sigma * sigma) * t;
  float vol_t = sigma * sqrtf(t);
  long double sum = 0.0L, sum2 = 0.0L;
  for (uint64_t i = begin; i < end; ++i) {
    float pay;
    if (payoff_kind == 2) {
      // element i covers paths (2i, 2i+1); caller passes element range
      float z0, z1;
      normal_pair(k0, k1, (uint32_t)i, 0, rounds, &z0, &z1);
      float sa = s0 * expf(drift_t + vol_t * z0);
      float sb = s0 * expf(drift_t + vol_t * z1);
      float pa = sa > k ? sa - k : 0.0f;
      float pb = sb > k ? sb - k : 0.0f;
      sum += (long double)pa + (long double)pb;
      sum2 += (long double)pa * pa + (long double)pb * pb;
      continue;
    }
    if (payoff_kind == 0) {
      float z = normal_draw(k0, k1, (uint32_t)i, 0, rounds);
      float st = s0 * expf(drift_t + vol_t * z);
      pay = st > k ? st - k : 0.0f;
    } else {
      // Log-space accumulation, matching the device kernels: each S_t carries
      // exactly one expf rounding instead of a compounded product.
      float w = 0.0f;
      float st = s0;
      float count = 0.0f;
      for (int j = 0; j < n_steps; ++j) {
        float z = normal_draw(k0, k1, (uint32_t)i, (uint32_t)j, rounds);
        w += drift_dt + vol_dt * z;
        st = s0 * expf(w);
        if (st < barrier) count += 1.0f;
      }
      bool in_window = count >= p1 && count <= p2;
      pay = (in_window && st > k) ? st - k : 0.0f;
    }
    sum += (long double)pay;
    sum2 += (long double)pay * (long double)pay;
  }
  out->sum = sum;
  out->sum2 = sum2;
}

double price_cpu(int payoff_kind, uint32_t k0, uint32_t k1, uint64_t n_paths,
                 int n_steps, float s0, float k, float r, float sigma,
                 float t, float barrier, float p1, float p2, float q,
                 int rounds, int n_threads, double* stderr_out) {
  if (n_threads <= 0)
    n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if ((uint64_t)n_threads > n_paths) n_threads = (int)n_paths;
  std::vector<Moments> parts(n_threads);
  std::vector<std::thread> workers;
  uint64_t chunk = (n_paths + n_threads - 1) / n_threads;
  for (int w = 0; w < n_threads; ++w) {
    uint64_t b = (uint64_t)w * chunk;
    uint64_t e = b + chunk < n_paths ? b + chunk : n_paths;
    if (b >= e) break;
    workers.emplace_back(price_slice, payoff_kind, k0, k1, b, e, n_steps, s0,
                         k, r, sigma, t, barrier, p1, p2, q, rounds,
                         &parts[w]);
  }
  for (auto& th : workers) th.join();
  long double sum = 0.0L, sum2 = 0.0L;
  for (auto& m : parts) {
    sum += m.sum;
    sum2 += m.sum2;
  }
  // kind 2 prices TWO paths per loop element
  long double n = (long double)n_paths * (payoff_kind == 2 ? 2.0L : 1.0L);
  long double mean = sum / n;
  long double var = sum2 / n - mean * mean;
  if (var < 0.0L) var = 0.0L;
  if (n > 1.0L) var *= n / (n - 1.0L);
  double disc = exp(-(double)r * (double)t);
  if (stderr_out) *stderr_out = disc * sqrt((double)(var / n));
  return disc * (double)mean;
}

// Fill `out[n]` with normal draw j of paths [0, n) — for cross-checking the
// native stream against rng.normals bit by bit.
void fill_normals(uint32_t k0, uint32_t k1, uint32_t j, uint64_t n,
                  int rounds, float* out) {
  for (uint64_t i = 0; i < n; ++i)
    out[i] = normal_draw(k0, k1, (uint32_t)i, j, rounds);
}

// ---------------------------------------------------------------------------
// CSV trajectory writer (testing.cu:37-47 tidy format).
// mat is row-major (n_paths, n_steps).
// ---------------------------------------------------------------------------

int write_traj_csv(const char* path, const float* mat, uint64_t n_paths,
                   uint64_t n_steps) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fputs("time,trajectory,value\n", f);
  for (uint64_t j = 0; j < n_steps; ++j)
    for (uint64_t i = 0; i < n_paths; ++i)
      fprintf(f, "%llu,%llu,%.6f\n", (unsigned long long)j,
              (unsigned long long)i, (double)mat[i * n_steps + j]);
  fclose(f);
  return 0;
}

}  // extern "C"
