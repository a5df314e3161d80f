// Occupation kernel of the HOD families for Hopper (sm_90a).
//
// occupation_kernel: the per-bin galaxy density
//
//     n[b, i] = sum_g occ(params_b, node_ig) * w[i, g],
//     w[i, g] = quad_weight[i, g] * n_h[i],
//
// of the SHMR, CLF and quiescent/active families -- Leauthaud11,
// ZuMandelbaum15, Tinker13 and Cacciato09, each optionally with the
// Heaviside assembly-bias decoration -- for a batch of parameter vectors.
// It is the occupation phase the Pallas kernels B1, B2 and B4 trace in
// their bodies for these models (tabcorr_tpu/ops/fused.py:985, 1373, 1941,
// under pallas_lowering); here it is its own launch, and the bundle, grid
// and slab kernels read its densities as model code 2 (zheng07.cuh).  The
// contraction route (B3) reads them too, row-major.
//
// The expressions follow tabcorr_tpu_torch/models/*.py.  The precision
// does not: each node is evaluated at its float64 abscissa, the float32
// node plus its float64 residual (both from the table), so that no
// residual absorption is needed:
//
//   * The SHMR inversion log10 M*(log10 Mh) runs as tabcorr_tpu's
//     in-kernel inversion does -- 15 bisection halvings of [5, 13] and
//     three Newton steps, in float32 at the float32 node (the bisection
//     with the fast intrinsics: it only seeds), except that a bin's later
//     nodes start their Newton steps from the node before -- and then
//     one Newton step in float64 at the float64 node, which takes the
//     float32 root (a few ulp off) to float64 precision.
//   * Everything after it (erfc, the satellites' power laws, Tinker13's
//     quiescent-fraction spline, the decoration), and the whole Cacciato09
//     CLF with its Gamma(a, x) for a in (-1, 1.5], is float64, and so is
//     the quadrature sum; the density is rounded to float32 once.
//
// What bounds it on an H100: the operations.  Per (row, node) the
// inversion costs 6 accurate float32 exp10 (and per bin the bisection's
// 30 fast ones) and two float64 exp10, the erfc and the satellites'
// power law are float64, and
// Cacciato09's Gamma(a, x) is a float64 series or continued fraction of
// ~20-40 terms; the bytes are 4 per density written and the parameters
// read.
//
// What the design does about it: one thread per batch row, 128 rows a
// block, each block a few consecutive bins (gridDim.y), so that a row's
// parameter terms are formed once per block and every thread of a warp
// reads the same nodes (broadcast loads) and writes consecutive rows of
// one bin (coalesced, in the bin-major layout).  The family is a template
// parameter: a launch compiles no other family's code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLeauthaud11 = 0;   // families (the template parameter)
constexpr int kZuMandelbaum15 = 1;
constexpr int kTinker13 = 2;
constexpr int kCacciato09 = 3;
constexpr int kSfrAll = 0;        // Tinker13's sfr_designation
constexpr int kSfrQuiescent = 1;
constexpr int kSfrActive = 2;

constexpr int kRows = 128;        // threads (batch rows) per block
constexpr int kShmrCols = 16;     // one Leauthaud11-layout SHMR population
constexpr int kMaxSplinePoints = 8;
constexpr int kMaxSplineCoeffs = 6;

constexpr double kLn10 = 2.302585092994046;
constexpr float kLn10f = 2.302585092994046f;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kPi = 3.141592653589793;
constexpr double kLog10_0562 = -0.2502636844309389;   // log10(0.562)
constexpr double kSigmaFloor = 1e-6;     // models/zu_mandelbaum15.py
constexpr double kGammaTol = 1e-5;       // utils/special.py _TOL64
constexpr double kGammaXFloor = 1e-35;   // utils/special.py _X_FLOOR
constexpr float kBracketLo = 5.0f;       // the inversion's log10 M* range
constexpr float kBracketHi = 13.0f;
constexpr int kBisectSteps = 15;
constexpr int kNewtonSteps = 3;

// What a launch needs of the model and the table.  Parameter columns, in
// order (ops/fused.py:OccupationFamily):
//   Leauthaud11     one SHMR population: smhm_{m0,m1,beta,delta,gamma}_{0,a},
//                   scatter_model_param1, alphasat, betasat, bsat,
//                   betacut, bcut (16);
//   ZuMandelbaum15  smhm_m0, smhm_m1, smhm_{beta,delta,gamma}, smhm_sigma,
//                   smhm_sigma_slope, alphasat, betasat, bsat, betacut,
//                   bcut (12);
//   Tinker13        the quiescent population (16), the active one (16),
//                   the n_pts quiescent-fraction ordinates;
//   Cacciato09      log_L_0, log_M_1, gamma_1, gamma_2, sigma, a_1, a_2,
//                   log_M_2, b_0, b_1, b_2, delta_1, delta_2 (13);
// then, decorated, the central and satellite assembly-bias strengths.
struct OccArgs {
  const float* params;   // (n_params, batch): one row per column
  int batch, n_params;
  int decorated, modulate, sfr;
  double threshold;      // the model's threshold
  double a;              // scale factor 1 / (1 + z) (Leauthaud11, Tinker13)
  double log_h;          // log10 littleh (Leauthaud11, Tinker13)
  double ratio;          // split / (1 - split)
  double below_scale;    // (1 - split) / split
  float edge;            // split - 1e-6, the knife-edge of the split
  const double* spline;  // Tinker13: breaks (n_seg + 1), then the
                         // coefficients (n_seg, n_coef, n_pts)
  int n_seg, n_coef, n_pts;
  const float* logm;     // (nb, ng) float32 node log10 mass
  const float* res;      // (nb, ng) its float64 residual, in float32
  const float* sec;      // (nb, ng) secondary percentile
  const float* w;        // (nb, ng) quad_weight * n_h
  int nb, nc, ng;
  int bins_per_block;
  int bin_major;         // dens is (nb, batch); else (batch, nb)
  float* dens;
};

__device__ __forceinline__ double par(const OccArgs& A, int col, int b) {
  return static_cast<double>(__ldg(A.params + (size_t)col * A.batch + b));
}

// ---------------------------------------------------------------------
// Behroozi et al. (2010) relation log10 Mh(log10 M*) of one row and its
// inversion (models/leauthaud11.py)
// ---------------------------------------------------------------------
struct Shmr {
  double log_m1, x0, beta, delta, gamma, tail;   // x = ls - x0
  float f_log_m1, f_x0, f_beta, f_delta, f_gamma, f_tail;
};

__device__ Shmr make_shmr(double log_m1, double log_m0, double beta,
                          double delta, double gamma, double log_h) {
  Shmr s;
  s.log_m1 = log_m1;
  s.x0 = log_m0 - 2.0 * log_h;
  s.beta = beta;
  s.delta = delta;
  s.gamma = gamma;
  s.tail = 0.5 + log_h;
  s.f_log_m1 = static_cast<float>(s.log_m1);
  s.f_x0 = static_cast<float>(s.x0);
  s.f_beta = static_cast<float>(beta);
  s.f_delta = static_cast<float>(delta);
  s.f_gamma = static_cast<float>(gamma);
  s.f_tail = static_cast<float>(s.tail);
  return s;
}

__device__ __forceinline__ double shmr_log_mh(const Shmr& s, double ls) {
  const double x = ls - s.x0;
  return s.log_m1 + s.beta * x +
         exp10(s.delta * x) / (1.0 + exp10(-s.gamma * x)) - s.tail;
}

// The relation in float32 with the fast intrinsics, for the bisection
// seed only (the Newton steps after it use the accurate functions).
__device__ __forceinline__ float shmr_log_mh_fast(const Shmr& s, float ls) {
  const float x = ls - s.f_x0;
  return s.f_log_m1 + s.f_beta * x +
         __fdividef(__exp10f(s.f_delta * x),
                    1.0f + __exp10f(-s.f_gamma * x)) -
         s.f_tail;
}

// One Newton step of the relation towards y, float32; *df gets the
// derivative at ls.
__device__ __forceinline__ float newton_f(const Shmr& s, float ls, float y,
                                          float* df) {
  const float x = ls - s.f_x0;
  const float sd = exp10f(s.f_delta * x);
  const float sng = exp10f(-s.f_gamma * x);
  const float den = 1.0f + sng;
  const float f = s.f_log_m1 + s.f_beta * x + sd / den - s.f_tail;
  *df = s.f_beta + kLn10f * sd * (s.f_delta + (s.f_delta + s.f_gamma) * sng) /
                       (den * den);
  return ls - (f - y) / *df;
}

// log10 M* at the node (lm: float32, y: float64), see the header.
// `seed` is the float32 root at the bin's previous node, NaN at its first
// node: the bisection seeds the first node of a bin, and every later node
// starts its Newton steps from the node before (the nodes of a bin lie
// within a few hundredths of a dex of each other; warp-uniform, as every
// thread of a warp is at the same node).  The float64 step takes the
// float32 derivative: the root is a few ulp off, so the derivative's own
// float32 error moves the result by ~1e-13.
__device__ double shmr_log_mstar(const Shmr& s, float lm, double y,
                                 float* seed) {
  float ls = *seed;
  if (isnan(ls)) {
    float lo = kBracketLo, hi = kBracketHi;
    for (int k = 0; k < kBisectSteps; ++k) {
      const float mid = 0.5f * (lo + hi);
      if (shmr_log_mh_fast(s, mid) > lm)
        hi = mid;
      else
        lo = mid;
    }
    ls = 0.5f * (lo + hi);
  }
  float df = 1.0f;
  for (int k = 0; k < kNewtonSteps; ++k) ls = newton_f(s, ls, lm, &df);
  *seed = ls;
  const double x0 = static_cast<double>(ls);
  return x0 - (shmr_log_mh(s, x0) - y) / static_cast<double>(df);
}

// One SHMR population with its satellite scalings.
struct Population {
  Shmr s;
  double inv_scatter;   // 1 / (sqrt(2) scatter) (Leauthaud11 form)
  double log_msat, log_mcut, ln10_alpha;
  float seed;           // the inversion's root at the previous node
};

__device__ void satellite_terms(double threshold, double alphasat,
                                double betasat, double bsat, double betacut,
                                double bcut, Population* p) {
  const double log_mh_t = shmr_log_mh(p->s, threshold);
  p->log_msat = 12.0 + log10(bsat) + betasat * (log_mh_t - 12.0);
  p->log_mcut = 12.0 + log10(bcut) + betacut * (log_mh_t - 12.0);
  p->ln10_alpha = kLn10 * alphasat;
}

// A Leauthaud11-layout population at columns [c, c + 16) of row b.
__device__ Population leauthaud11_population(const OccArgs& A, int c, int b) {
  const double am1 = A.a - 1.0;
  Population p;
  p.s = make_shmr(par(A, c + 2, b) + par(A, c + 3, b) * am1,
                  par(A, c + 0, b) + par(A, c + 1, b) * am1,
                  par(A, c + 4, b) + par(A, c + 5, b) * am1,
                  par(A, c + 6, b) + par(A, c + 7, b) * am1,
                  par(A, c + 8, b) + par(A, c + 9, b) * am1, A.log_h);
  p.inv_scatter = 1.0 / (kSqrt2 * par(A, c + 10, b));
  satellite_terms(A.threshold, par(A, c + 11, b), par(A, c + 12, b),
                  par(A, c + 13, b), par(A, c + 14, b), par(A, c + 15, b),
                  &p);
  return p;
}

__device__ __forceinline__ double leauthaud11_centrals(Population& p,
                                                       double threshold,
                                                       float lm, double y) {
  return 0.5 *
         erfc((threshold - shmr_log_mstar(p.s, lm, y, &p.seed)) *
              p.inv_scatter);
}

// The power law with its cutoff, unmodulated.
__device__ __forceinline__ double satellite_power(const Population& p,
                                                  double y) {
  return exp(p.ln10_alpha * (y - p.log_msat) - exp10(p.log_mcut - y));
}

// ---------------------------------------------------------------------
// Gamma(a, x) for a in (-1, 1.5] and x > 0 (utils/special.py)
// ---------------------------------------------------------------------
// Gamma(s, x) for s > 0: Gamma(s) minus the lower series below x = s + 1,
// the modified-Lentz continued fraction above.
__device__ double gamma_upper_positive(double s, double x) {
  const double lnx = log(x);
  if (x < s + 1.0) {
    double ap = s, term = 1.0 / s, sum = term;
    for (int n = 0; n < 300; ++n) {
      ap += 1.0;
      term *= x / ap;
      sum += term;
      if (fabs(term) < fabs(sum) * 1e-17) break;
    }
    return tgamma(s) - sum * exp(s * lnx - x);
  }
  const double tiny = 1e-300;
  double bn = x + 1.0 - s, c = 1.0 / tiny, d = 1.0 / bn, h = d;
  for (int n = 1; n < 300; ++n) {
    const double an = -n * (n - s);
    bn += 2.0;
    d = an * d + bn;
    if (fabs(d) < tiny) d = tiny;
    c = bn + an / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < 1e-16) break;
  }
  return exp(s * lnx - x) * h;
}

// The non-regularized Gamma(a, x): direct for a >= tol, one step of the
// upward recurrence for a <= -tol, blended linearly in between.
__device__ double gamma_upper(double a, double x) {
  x = fmax(x, kGammaXFloor);
  if (a >= kGammaTol) return gamma_upper_positive(a, x);
  const double a_lo = fmin(a, -kGammaTol);
  const double g_lo =
      (gamma_upper_positive(a_lo + 1.0, x) - exp(a_lo * log(x) - x)) / a_lo;
  if (a <= -kGammaTol) return g_lo;
  const double w = fmin(fmax((a + kGammaTol) / (2.0 * kGammaTol), 0.0), 1.0);
  return (1.0 - w) * g_lo + w * gamma_upper_positive(kGammaTol, x);
}

// ---------------------------------------------------------------------
// The families: per-row terms, then the occupation at a node.  centrals()
// also sets the decoration's ceiling of the centrals.
// ---------------------------------------------------------------------
template <int FAMILY>
struct Row;

template <>
struct Row<kLeauthaud11> {
  Population p;
  __device__ Row(const OccArgs& A, int b)
      : p(leauthaud11_population(A, 0, b)) {}
  __device__ void new_bin() { p.seed = NAN; }
  __device__ double centrals(const OccArgs& A, float lm, double y,
                             double* ceiling) {
    return leauthaud11_centrals(p, A.threshold, lm, y);
  }
  __device__ double satellites(const OccArgs& A, float lm, double y) {
    const double nsat = satellite_power(p, y);
    return A.modulate ? nsat * leauthaud11_centrals(p, A.threshold, lm, y)
                      : nsat;
  }
};

template <>
struct Row<kZuMandelbaum15> {
  Population p;
  double log_m1, sigma, slope;
  __device__ Row(const OccArgs& A, int b) {
    log_m1 = log10(par(A, 1, b));
    p.s = make_shmr(log_m1, log10(par(A, 0, b)), par(A, 2, b), par(A, 3, b),
                    par(A, 4, b), 0.0);
    sigma = par(A, 5, b);
    slope = par(A, 6, b);
    p.inv_scatter = 0.0;   // the scatter depends on the mass: centrals()
    satellite_terms(A.threshold, par(A, 7, b), par(A, 8, b), par(A, 9, b),
                    par(A, 10, b), par(A, 11, b), &p);
  }
  __device__ void new_bin() { p.seed = NAN; }
  __device__ double centrals(const OccArgs& A, float lm, double y,
                             double* ceiling) {
    const double centered =
        A.threshold - shmr_log_mstar(p.s, lm, y, &p.seed);
    const double dln_mh = kLn10 * (y - log_m1);
    double s = sigma + slope * (dln_mh > 0.0 ? dln_mh : 0.0);
    s = s > kSigmaFloor ? s : kSigmaFloor;
    return 0.5 * erfc(kLn10 * centered / (kSqrt2 * s));
  }
  __device__ double satellites(const OccArgs& A, float lm, double y) {
    const double nsat = satellite_power(p, y);
    return A.modulate ? nsat * centrals(A, lm, y, nullptr) : nsat;
  }
};

template <>
struct Row<kTinker13> {
  Population q, act;   // quiescent, active
  double ords[kMaxSplinePoints];
  __device__ Row(const OccArgs& A, int b)
      : q(leauthaud11_population(A, 0, b)),
        act(leauthaud11_population(A, kShmrCols, b)) {
    for (int i = 0; i < kMaxSplinePoints; ++i)
      ords[i] = i < A.n_pts ? par(A, 2 * kShmrCols + i, b) : 0.0;
  }
  // f_q at the node: the segment of y, Horner in s = y - its left break,
  // clipped to [0, 1] (models/tinker13.py).
  __device__ double quiescent_fraction(const OccArgs& A, double y) const {
    const double* breaks = A.spline;
    const double* coeffs = A.spline + A.n_seg + 1;
    int j = 0;
    for (int k = 1; k < A.n_seg; ++k)
      if (y >= breaks[k]) j = k;
    const double s = y - breaks[j];
    double f = 0.0;
    for (int d = 0; d < A.n_coef; ++d) {
      const double* c = coeffs + (size_t)(j * A.n_coef + d) * A.n_pts;
      double cd = 0.0;
      for (int i = 0; i < A.n_pts; ++i) cd += c[i] * ords[i];
      f = f * s + cd;
    }
    return fmin(fmax(f, 0.0), 1.0);
  }
  __device__ void new_bin() { q.seed = act.seed = NAN; }
  __device__ double centrals(const OccArgs& A, float lm, double y,
                             double* ceiling) {
    const double fq = quiescent_fraction(A, y);
    if (A.sfr == kSfrQuiescent) {
      *ceiling = fq;
      return fq * leauthaud11_centrals(q, A.threshold, lm, y);
    }
    if (A.sfr == kSfrActive) {
      *ceiling = 1.0 - fq;
      return (1.0 - fq) * leauthaud11_centrals(act, A.threshold, lm, y);
    }
    return fq * leauthaud11_centrals(q, A.threshold, lm, y) +
           (1.0 - fq) * leauthaud11_centrals(act, A.threshold, lm, y);
  }
  __device__ double satellites(const OccArgs& A, float lm, double y) {
    if (A.sfr == kSfrQuiescent) return satellite_power(q, y);
    if (A.sfr == kSfrActive) return satellite_power(act, y);
    return satellite_power(q, y) + satellite_power(act, y);
  }
};

template <>
struct Row<kCacciato09> {
  double log_l0, log_m1, gamma_1, gamma_2, inv_sigma, a_1, a_2, log_m2, b_0,
      b_1, b_2, delta_1, delta_2;
  __device__ Row(const OccArgs& A, int b) {
    log_l0 = par(A, 0, b);
    log_m1 = par(A, 1, b);
    gamma_1 = par(A, 2, b);
    gamma_2 = par(A, 3, b);
    inv_sigma = 1.0 / (kSqrt2 * par(A, 4, b));
    a_1 = par(A, 5, b);
    a_2 = par(A, 6, b);
    log_m2 = par(A, 7, b);
    b_0 = par(A, 8, b);
    b_1 = par(A, 9, b);
    b_2 = par(A, 10, b);
    delta_1 = par(A, 11, b);
    delta_2 = par(A, 12, b);
  }
  __device__ void new_bin() {}
  // log10 L_c(M), with log10(1 + 10^x) free of cancellation.
  __device__ double median_log_luminosity(double y) const {
    const double x = y - log_m1;
    const double log1p10 = fmax(x, 0.0) + log1p(exp10(-fabs(x))) / kLn10;
    return log_l0 + gamma_1 * x - (gamma_1 - gamma_2) * log1p10;
  }
  __device__ double centrals(const OccArgs& A, float lm, double y,
                             double* ceiling) const {
    return 0.5 * erfc((A.threshold - median_log_luminosity(y)) * inv_sigma);
  }
  __device__ double satellites(const OccArgs& A, float lm, double y) const {
    const double m12 = y - 12.0;
    const double log_ls = median_log_luminosity(y) + kLog10_0562;
    const double alpha_sat =
        -2.0 + a_1 * (1.0 - (2.0 / kPi) * atan(a_2 * (y - log_m2)));
    const double log_phi = b_0 + b_1 * m12 + b_2 * m12 * m12;
    const double log_delta = delta_1 + delta_2 * m12;
    const double a = 0.5 * (alpha_sat + 1.0);
    const double x = exp10(log_delta + 2.0 * (A.threshold - log_ls));
    return 0.5 * exp10(log_phi - a * log_delta) * gamma_upper(a, x);
  }
};

// heaviside_assembias of models/assembias.py in float64: `ceiling` bounds
// the centrals (1, or Tinker13's population fraction); satellites have no
// upper bound.
__device__ __forceinline__ double decorate(double base, double strength,
                                          bool above, bool bounded,
                                          double ceiling, const OccArgs& A) {
  strength = fmin(fmax(strength, -1.0), 1.0);
  double room_up, room_down;
  if (bounded) {
    room_up = fmin(ceiling - base, A.ratio * base);
    room_down = fmin(base, A.ratio * (ceiling - base));
  } else {
    room_up = A.ratio * base;
    room_down = base;
  }
  const double delta =
      strength >= 0.0 ? strength * room_up : strength * room_down;
  return above ? base + delta : base - delta * A.below_scale;
}

template <int FAMILY>
__global__ void __launch_bounds__(kRows)
occupation_kernel(const OccArgs A) {
  const int b = blockIdx.x * kRows + threadIdx.x;
  if (b >= A.batch) return;
  Row<FAMILY> row(A, b);
  double strength_c = 0.0, strength_s = 0.0;
  if (A.decorated) {
    strength_c = par(A, A.n_params - 2, b);
    strength_s = par(A, A.n_params - 1, b);
  }
  const int i0 = blockIdx.y * A.bins_per_block;
  const int i1 = min(i0 + A.bins_per_block, A.nb);
  for (int i = i0; i < i1; ++i) {
    const bool central = i < A.nc;
    const float* lm = A.logm + (size_t)i * A.ng;
    const float* rs = A.res + (size_t)i * A.ng;
    const float* w = A.w + (size_t)i * A.ng;
    const bool above = A.sec[(size_t)i * A.ng] >= A.edge;
    row.new_bin();
    double acc = 0.0;
    for (int g = 0; g < A.ng; ++g) {
      const float lmg = lm[g];
      const double y = static_cast<double>(lmg) + static_cast<double>(rs[g]);
      double occ;
      if (central) {
        double ceiling = 1.0;
        occ = row.centrals(A, lmg, y, &ceiling);
        if (A.decorated)
          occ = decorate(occ, strength_c, above, true, ceiling, A);
      } else {
        occ = row.satellites(A, lmg, y);
        if (A.decorated)
          occ = decorate(occ, strength_s, above, false, 0.0, A);
      }
      acc = fma(occ, static_cast<double>(w[g]), acc);
    }
    const size_t at = A.bin_major ? (size_t)i * A.batch + b
                                  : (size_t)b * A.nb + i;
    A.dens[at] = static_cast<float>(acc);
  }
}

// Parameter columns of a family (before the strengths).
int family_columns(int family, int n_pts) {
  switch (family) {
    case kLeauthaud11:
      return kShmrCols;
    case kZuMandelbaum15:
      return 12;
    case kTinker13:
      return 2 * kShmrCols + n_pts;
    case kCacciato09:
      return 13;
    default:
      return -1;
  }
}

template <int FAMILY>
int launch(const OccArgs& A, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (A.batch == 0) return 0;
  const dim3 grid((A.batch + kRows - 1) / kRows,
                  (A.nb + A.bins_per_block - 1) / A.bins_per_block);
  occupation_kernel<FAMILY>
      <<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the occupation kernel on `stream`: the densities of `family`
// (0 Leauthaud11, 1 ZuMandelbaum15, 2 Tinker13, 3 Cacciato09; `decorated`
// adds the two strength columns) for `batch` rows of `params` ((n_params,
// batch) float32, the columns of OccArgs) over the table's quadrature
// (nb, ng) arrays, nc central bins first, `bins_per_block` bins a block,
// into `dens` ((nb, batch) if `bin_major`, else (batch, nb)).  `sfr` is
// Tinker13's designation (0 all, 1 quiescent, 2 active) and `spline` its
// quiescent-fraction map (float64, on the device).  Returns the CUDA error
// code of the launch (0 on success); the kernel runs asynchronously.
int tabcorr_occupation(const float* params, int batch, int n_params,
                       int family, int decorated, int modulate, int sfr,
                       double threshold, double a, double log_h,
                       double split, const double* spline, int n_seg,
                       int n_coef, int n_pts, const float* logm,
                       const float* res, const float* sec, const float* w,
                       int nb, int nc, int ng, int bins_per_block,
                       int bin_major, float* dens, int device,
                       void* stream) {
  const int cols = family_columns(family, n_pts);
  const bool tinker = family == kTinker13;
  const bool bad =
      cols < 0 || n_params != cols + (decorated ? 2 : 0) || batch < 0 ||
      nb <= 0 || ng <= 0 || nc < 0 || nc > nb || bins_per_block <= 0 ||
      (nb + bins_per_block - 1) / bins_per_block > 65535 ||
      !(split > 0.0 && split < 1.0) || (batch > 0 && (!params || !dens)) ||
      !logm || !res || !sec || !w ||
      (tinker && (!spline || n_seg < 1 || n_coef < 1 ||
                  n_coef > kMaxSplineCoeffs || n_pts < 2 ||
                  n_pts > kMaxSplinePoints || sfr < kSfrAll ||
                  sfr > kSfrActive));
  if (bad) return (int)cudaErrorInvalidValue;
  OccArgs A = {};
  A.params = params;
  A.batch = batch;
  A.n_params = n_params;
  A.decorated = decorated;
  A.modulate = modulate;
  A.sfr = sfr;
  A.threshold = threshold;
  A.a = a;
  A.log_h = log_h;
  A.ratio = split / (1.0 - split);
  A.below_scale = (1.0 - split) / split;
  A.edge = static_cast<float>(split - 1e-6);
  A.spline = spline;
  A.n_seg = n_seg;
  A.n_coef = n_coef;
  A.n_pts = n_pts;
  A.logm = logm;
  A.res = res;
  A.sec = sec;
  A.w = w;
  A.nb = nb;
  A.nc = nc;
  A.ng = ng;
  A.bins_per_block = bins_per_block;
  A.bin_major = bin_major;
  A.dens = dens;
  switch (family) {
    case kLeauthaud11:
      return launch<kLeauthaud11>(A, device, stream);
    case kZuMandelbaum15:
      return launch<kZuMandelbaum15>(A, device, stream);
    case kTinker13:
      return launch<kTinker13>(A, device, stream);
    default:
      return launch<kCacciato09>(A, device, stream);
  }
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
