// Occupation kernel of the HOD families for Hopper (sm_90a).
//
// occupation_kernel: the per-bin galaxy density
//
//     n[b, i] = sum_g occ(params_b, node_ig) * w[i, g],
//     w[i, g] = quad_weight[i, g] * n_h[i],
//
// of the SHMR, CLF and quiescent/active families -- Leauthaud11,
// ZuMandelbaum15, Tinker13 and Cacciato09, each optionally with the
// Heaviside assembly-bias decoration -- for a batch of parameter vectors,
// for every table one launch serves (one table, a grid's stacked table, or
// every table of a bundle).  It is the occupation phase the Pallas kernels
// B1, B2 and B4 trace in their bodies for these models
// (tabcorr_tpu/ops/fused.py:985, 1373, 1941, under pallas_lowering); here
// it is its own launch, and the bundle, grid and slab kernels read its
// densities as model code 2 (zheng07.cuh).  The contraction route (B3)
// reads them too, row-major.
//
// The expressions follow tabcorr_tpu_torch/models/*.py.  The precision
// does not: each node is evaluated at its float64 abscissa, the float32
// node plus its float64 residual (both from the table), so that no
// residual absorption is needed:
//
//   * The SHMR inversion log10 M*(log10 Mh) runs as tabcorr_tpu's
//     in-kernel inversion does -- 15 bisection halvings of [5, 13] and
//     three Newton steps, in float32 at the float32 node (the bisection
//     with the fast intrinsics: it only seeds), except that a node starts
//     its Newton steps from the root at the node evaluated before it --
//     and then one Newton step in float64 at the float64 node, which takes
//     the float32 root (a few ulp off) to float64 precision.  Each
//     float32 step is held to [5, 13], as models/leauthaud11.py
//     shmr_inverse holds its own (a root held at an end is that end), and
//     the result is NaN, without a walk, where the relation is not
//     increasing by its form (beta, delta or gamma not positive;
//     shmr_increasing); so are the Leauthaud11-form centrals where their
//     scatter is not positive (models/leauthaud11.py positive).
//   * Everything after it (erfc, the satellites' power laws, Tinker13's
//     quiescent-fraction spline, the decoration), and the whole Cacciato09
//     CLF with its Gamma(a, x) for a in (-1, 1.5], is float64, and so is
//     the quadrature sum; the density is rounded to float32 once.
//
// What bounds it on an H100: the instruction rate (one warp instruction
// a cycle per scheduler).  A (row, node) of the decorated Leauthaud11
// takes ~700 instructions on its hot path (SASS): ~200 for the three
// float32 Newton steps, ~220 FP64 in the float64 step, the erfc and the
// satellites' power law (libdevice sequences of tens of FP64 instructions
// each), the rest conversions, selects, loads and the quadrature;
// Cacciato09's Gamma(a, x) is a float64 series or continued fraction of
// ~20-40 terms.  The FP64 pipe is busy about 40% of the time.  The bytes
// are 4 per density written.
//
// What the design does about it: the work is laid out by the node plan
// (ops/fused.py: OccupationPlan), built once per predictor on the host.
// The tables repeat each mass bin 2-4 times -- central and satellite, and
// for the secondary-percentile split above and below -- so the plan
// groups the distinct (float32 node, float32 residual) abscissae into
// units, one mass bin's n_gauss nodes each, sorted by mass, and lists for
// each unit the output bins that read it (at most kMaxOuts).  One thread
// per batch row, kRows rows a block, each block a run of consecutive units
// (gridDim.y): per unit each node is evaluated once -- the central
// occupation with its inversion and erfc where any output or the
// satellites' modulation reads it, the satellites' where any output reads
// them, reusing that central value -- and then every output bin of the
// unit is decorated and summed in float64, in node order, in registers,
// rounded once and stored (coalesced, in the bin-major layout).  For
// Leauthaud11 a node's centrals and satellites are each decorated once
// (kSharedDecoration): the shift is the same for the unit's outputs above
// and below the split, so an output costs a select and an FMA.  The
// float32 Newton warm start carries from node to node and unit to unit in
// ascending mass, so the bisection seeds only a block's first node (and a
// node more than kReseedGap dex from the last one inverted).  The float32
// walk and the float64 rest of a node run one after the other in a
// thread; other warps' phases fill the pipes beside them (walking two
// nodes before their float64 rest measured slower: ptxas keeps each
// node's libdevice sequences, cut at the float64 division's slow-path
// call and erfc's branches, one after the other).  A row's parameter
// terms are formed once per block; every thread of a warp reads the same
// plan entries (broadcast loads).  The family is a template parameter: a
// launch compiles no other family's code.

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
constexpr int kMaxTables = 4;     // tables one launch serves
constexpr int kMaxOuts = 4;       // output bins of one unit of the plan
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
// A warm start further than this (dex of halo mass) from the node is
// reseeded by the bisection: three float32 Newton steps from 0.1 dex away
// reach the float32 root as from the bisection, from 0.3 dex they do not.
constexpr float kReseedGap = 0.15f;
// So is one whose tangent puts the node's root further than this (dex of
// stellar mass) from it: a flat relation (a small beta) moves the root by
// many dex between close nodes, and Newton steps from there diverge.
constexpr float kReseedMove = 0.1f;

// What a launch needs of the model and the node plan.  Parameter columns,
// in order (ops/fused.py:OccupationFamily):
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
  // The node plan: per unit its float32 nodes and their float64
  // residuals (n_units, ng) and its outputs [first_out[u],
  // first_out[u + 1]); per output its bin, table, secondary percentile
  // and weights (n_out, ng).
  const float* node;
  const float* res;
  const int* first_out;
  const int* out_bin;
  const int* out_table;
  const float* out_sec;
  const float* w;
  int n_units, ng, units_per_block;
  int nb[kMaxTables], nc[kMaxTables];
  float* dens[kMaxTables];   // (nb, batch) if bin_major; else (batch, nb)
  int bin_major;
};

__device__ __forceinline__ double par(const OccArgs& A, int col, int b) {
  return static_cast<double>(__ldg(A.params + (size_t)col * A.batch + b));
}

// a[t] of a by-value kernel argument, by selects (an indexed load would
// copy the array to local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxTables], int t) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxTables; ++k)
    if (t == k) v = a[k];
  return v;
}

// ---------------------------------------------------------------------
// Behroozi et al. (2010) relation log10 Mh(log10 M*) of one row and its
// inversion (models/leauthaud11.py)
// ---------------------------------------------------------------------
struct Shmr {
  double log_m1, x0, beta, delta, gamma, tail;   // x = ls - x0
  float f_log_m1, f_x0, f_beta, f_delta, f_gamma, f_tail;
  bool increasing;   // beta, delta, gamma > 0: the inverse's domain
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
  s.increasing = beta > 0.0 && delta > 0.0 && gamma > 0.0;
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

// The float32 root of the node inverted before (NaN: none yet in this
// block), the float32 node it was found at and the relation's slope there.
struct WarmStart {
  float root, at, df;
};

// log10 M* at the node (lm: float32, y: float64), see the header.  The
// Newton steps start from the root at the node inverted before (every
// thread of a warp is at the same node, so the gap's branch is
// warp-uniform; the slope's is not); the bisection seeds a block's first
// node, a node more than kReseedGap from that one, and a node whose root
// the slope there puts more than kReseedMove away.  The float64 step
// takes the float32 derivative: the root is a few ulp off, so the
// derivative's own float32 error moves the result by ~1e-13.  Inlined at
// every call, so that a population's terms and warm start stay in
// registers (Tinker13 calls it for two).
__device__ __forceinline__ double shmr_log_mstar(const Shmr& s, float lm,
                                                 double y, WarmStart* warm) {
  if (!s.increasing) return NAN;   // no inverse: skip the walk
  float ls = warm->root;
  const float gap = fabsf(lm - warm->at);
  if (isnan(ls) || gap > kReseedGap || !(gap <= kReseedMove * warm->df)) {
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
  for (int k = 0; k < kNewtonSteps; ++k)
    ls = fminf(fmaxf(newton_f(s, ls, lm, &df), kBracketLo), kBracketHi);
  warm->root = ls;
  warm->at = lm;
  warm->df = df;
  // Held at an end of the bracket, the root lies beyond it: the end.
  if (ls <= kBracketLo || ls >= kBracketHi) return static_cast<double>(ls);
  const double x0 = static_cast<double>(ls);
  return x0 - (shmr_log_mh(s, x0) - y) / static_cast<double>(df);
}

// One SHMR population with its satellite scalings.
struct Population {
  Shmr s;
  double inv_scatter;   // 1 / (sqrt(2) scatter) (Leauthaud11 form)
  double log_msat, log_mcut, ln10_alpha;
  WarmStart warm;
};

__device__ void satellite_terms(double threshold, double alphasat,
                                double betasat, double bsat, double betacut,
                                double bcut, Population* p) {
  const double log_mh_t = shmr_log_mh(p->s, threshold);
  p->log_msat = 12.0 + log10(bsat) + betasat * (log_mh_t - 12.0);
  p->log_mcut = 12.0 + log10(bcut) + betacut * (log_mh_t - 12.0);
  p->ln10_alpha = kLn10 * alphasat;
  p->warm = {NAN, 0.0f, 0.0f};
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
  const double scatter = par(A, c + 10, b);   // NaN unless positive
  p.inv_scatter = scatter > 0.0 ? 1.0 / (kSqrt2 * scatter) : NAN;
  satellite_terms(A.threshold, par(A, c + 11, b), par(A, c + 12, b),
                  par(A, c + 13, b), par(A, c + 14, b), par(A, c + 15, b),
                  &p);
  return p;
}

__device__ __forceinline__ double leauthaud11_centrals(Population& p,
                                                       double threshold,
                                                       float lm, double y) {
  return 0.5 *
         erfc((threshold - shmr_log_mstar(p.s, lm, y, &p.warm)) *
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
// The families: per-row terms, then the occupations at one node.
// ---------------------------------------------------------------------
// The base (undecorated) occupations at a node, and the decoration's
// ceiling of the centrals (1, or Tinker13's population fraction).
struct NodeOcc {
  double cen, sat, ceiling;
};

template <int FAMILY>
struct Row;

// Leauthaud11 and ZuMandelbaum15: the satellites modulated by the
// node's centrals (the same value) where the model says so.
template <>
struct Row<kLeauthaud11> {
  Population p;
  __device__ Row(const OccArgs& A, int b)
      : p(leauthaud11_population(A, 0, b)) {}
  __device__ NodeOcc node(const OccArgs& A, float lm, double y, bool cen,
                          bool sat) {
    NodeOcc v = {0.0, 0.0, 1.0};
    if (cen || (sat && A.modulate))
      v.cen = leauthaud11_centrals(p, A.threshold, lm, y);
    if (sat) {
      v.sat = satellite_power(p, y);
      if (A.modulate) v.sat *= v.cen;
    }
    return v;
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
  __device__ double centrals(const OccArgs& A, float lm, double y) {
    const double centered =
        A.threshold - shmr_log_mstar(p.s, lm, y, &p.warm);
    const double dln_mh = kLn10 * (y - log_m1);
    double s = sigma + slope * (dln_mh > 0.0 ? dln_mh : 0.0);
    s = s > kSigmaFloor ? s : kSigmaFloor;
    return 0.5 * erfc(kLn10 * centered / (kSqrt2 * s));
  }
  __device__ NodeOcc node(const OccArgs& A, float lm, double y, bool cen,
                          bool sat) {
    NodeOcc v = {0.0, 0.0, 1.0};
    if (cen || (sat && A.modulate)) v.cen = centrals(A, lm, y);
    if (sat) {
      v.sat = satellite_power(p, y);
      if (A.modulate) v.sat *= v.cen;
    }
    return v;
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
  // clipped to [0, 1] (models/tinker13.py).  The ordinates' loop runs to
  // kMaxSplinePoints so that `ords` stays in registers (an index known
  // only at run time would put it in local memory).
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
#pragma unroll
      for (int i = 0; i < kMaxSplinePoints; ++i)
        if (i < A.n_pts) cd += __ldg(c + i) * ords[i];
      f = f * s + cd;
    }
    return fmin(fmax(f, 0.0), 1.0);
  }
  // The satellites are not modulated (models/tinker13.py).
  __device__ NodeOcc node(const OccArgs& A, float lm, double y, bool cen,
                          bool sat) {
    NodeOcc v = {0.0, 0.0, 1.0};
    if (cen) {
      const double fq = quiescent_fraction(A, y);
      if (A.sfr == kSfrQuiescent) {
        v.ceiling = fq;
        v.cen = fq * leauthaud11_centrals(q, A.threshold, lm, y);
      } else if (A.sfr == kSfrActive) {
        v.ceiling = 1.0 - fq;
        v.cen = (1.0 - fq) * leauthaud11_centrals(act, A.threshold, lm, y);
      } else {
        v.cen = fq * leauthaud11_centrals(q, A.threshold, lm, y) +
                (1.0 - fq) * leauthaud11_centrals(act, A.threshold, lm, y);
      }
    }
    if (sat) {
      if (A.sfr == kSfrQuiescent)
        v.sat = satellite_power(q, y);
      else if (A.sfr == kSfrActive)
        v.sat = satellite_power(act, y);
      else
        v.sat = satellite_power(q, y) + satellite_power(act, y);
    }
    return v;
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
  // log10 L_c(M), with log10(1 + 10^x) free of cancellation.
  __device__ double median_log_luminosity(double y) const {
    const double x = y - log_m1;
    const double log1p10 = fmax(x, 0.0) + log1p(exp10(-fabs(x))) / kLn10;
    return log_l0 + gamma_1 * x - (gamma_1 - gamma_2) * log1p10;
  }
  // The satellites' Schechter-like CLF above the threshold at a node
  // whose central median is log_lc.
  __device__ double satellites(const OccArgs& A, double y,
                               double log_lc) const {
    const double m12 = y - 12.0;
    const double log_ls = log_lc + kLog10_0562;
    const double alpha_sat =
        -2.0 + a_1 * (1.0 - (2.0 / kPi) * atan(a_2 * (y - log_m2)));
    const double log_phi = b_0 + b_1 * m12 + b_2 * m12 * m12;
    const double log_delta = delta_1 + delta_2 * m12;
    const double a = 0.5 * (alpha_sat + 1.0);
    const double x = exp10(log_delta + 2.0 * (A.threshold - log_ls));
    return 0.5 * exp10(log_phi - a * log_delta) * gamma_upper(a, x);
  }
  __device__ NodeOcc node(const OccArgs& A, float lm, double y, bool cen,
                          bool sat) const {
    NodeOcc v = {0.0, 0.0, 1.0};
    const double log_lc = median_log_luminosity(y);
    if (cen) v.cen = 0.5 * erfc((A.threshold - log_lc) * inv_sigma);
    if (sat) v.sat = satellites(A, y, log_lc);
    return v;
  }
};

// heaviside_assembias of models/assembias.py in float64, for a strength
// already clipped to [-1, 1]: the shift of `base` above the split (below
// it, the shift times -(1 - split) / split).  `ceiling` bounds the
// centrals (1, or Tinker13's population fraction); satellites have no
// upper bound.
__device__ __forceinline__ double decoration(double base, double strength,
                                            bool bounded, double ceiling,
                                            const OccArgs& A) {
  double room_up, room_down;
  if (bounded) {
    room_up = fmin(ceiling - base, A.ratio * base);
    room_down = fmin(base, A.ratio * (ceiling - base));
  } else {
    room_up = A.ratio * base;
    room_down = base;
  }
  return strength >= 0.0 ? strength * room_up : strength * room_down;
}

__device__ __forceinline__ double decorate(double base, double strength,
                                          bool above, bool bounded,
                                          double ceiling, const OccArgs& A) {
  const double delta = decoration(base, strength, bounded, ceiling, A);
  return above ? base + delta : base - delta * A.below_scale;
}

// Blocks per SM each family's registers must allow (0: no minimum, ptxas
// chooses).  Tinker13 and Cacciato09 take 128 registers unbounded and run
// faster held to 80 (six blocks of 128 rows); Leauthaud11 and
// ZuMandelbaum15 run fastest left to ptxas (64-70 registers; a minimum of
// one block already takes them to 90).
template <int FAMILY>
constexpr int kMinBlocks =
    FAMILY == kTinker13 || FAMILY == kCacciato09 ? 6 : 0;

// Families whose node loop decorates each population once a node, for
// every output of the unit; the others decorate each output (ptxas' code
// for ZuMandelbaum15 and Tinker13 measured slower with the shared form).
template <int FAMILY>
constexpr bool kSharedDecoration = FAMILY == kLeauthaud11;

template <int FAMILY>
__global__ void __launch_bounds__(kRows, kMinBlocks<FAMILY>)
occupation_kernel(const OccArgs A) {
  const int b = blockIdx.x * kRows + threadIdx.x;
  if (b >= A.batch) return;
  Row<FAMILY> row(A, b);
  double strength_c = 0.0, strength_s = 0.0;
  if (A.decorated) {
    strength_c = fmin(fmax(par(A, A.n_params - 2, b), -1.0), 1.0);
    strength_s = fmin(fmax(par(A, A.n_params - 1, b), -1.0), 1.0);
  }
  const int u0 = blockIdx.y * A.units_per_block;
  const int u1 = min(u0 + A.units_per_block, A.n_units);
  for (int u = u0; u < u1; ++u) {
    // The unit's outputs (warp-uniform): bit o of `central` and of
    // `above` flags output o.
    const int o0 = __ldg(A.first_out + u);
    const int n_out = __ldg(A.first_out + u + 1) - o0;
    unsigned central = 0, above = 0;
#pragma unroll
    for (int o = 0; o < kMaxOuts; ++o) {
      if (o < n_out) {
        const int t = __ldg(A.out_table + o0 + o);
        if (__ldg(A.out_bin + o0 + o) < pick(A.nc, t)) central |= 1u << o;
        if (__ldg(A.out_sec + o0 + o) >= A.edge) above |= 1u << o;
      }
    }
    const unsigned all = (1u << n_out) - 1u;
    const bool need_cen = central != 0, need_sat = central != all;
    double acc[kMaxOuts];
#pragma unroll
    for (int o = 0; o < kMaxOuts; ++o) acc[o] = 0.0;
    const float* lm = A.node + (size_t)u * A.ng;
    const float* rs = A.res + (size_t)u * A.ng;
    for (int g = 0; g < A.ng; ++g) {
      const float lmg = __ldg(lm + g);
      const double y =
          static_cast<double>(lmg) + static_cast<double>(__ldg(rs + g));
      const NodeOcc v = row.node(A, lmg, y, need_cen, need_sat);
      if constexpr (kSharedDecoration<FAMILY>) {
        // The node's four occupations (centrals and satellites, above and
        // below the split), each population decorated once.
        double cen_hi = v.cen, cen_lo = v.cen, sat_hi = v.sat,
               sat_lo = v.sat;
        if (A.decorated) {
          if (need_cen) {
            const double d =
                decoration(v.cen, strength_c, true, v.ceiling, A);
            cen_hi = v.cen + d;
            cen_lo = v.cen - d * A.below_scale;
          }
          if (need_sat) {
            const double d = decoration(v.sat, strength_s, false, 1.0, A);
            sat_hi = v.sat + d;
            sat_lo = v.sat - d * A.below_scale;
          }
        }
#pragma unroll
        for (int o = 0; o < kMaxOuts; ++o) {
          if (o < n_out) {
            const bool hi = (above >> o) & 1u;
            const double occ = (central >> o) & 1u ? (hi ? cen_hi : cen_lo)
                                                   : (hi ? sat_hi : sat_lo);
            acc[o] = fma(occ,
                         static_cast<double>(
                             __ldg(A.w + (size_t)(o0 + o) * A.ng + g)),
                         acc[o]);
          }
        }
      } else {
#pragma unroll
        for (int o = 0; o < kMaxOuts; ++o) {
          if (o < n_out) {
            const bool is_cen = (central >> o) & 1u;
            double occ = is_cen ? v.cen : v.sat;
            if (A.decorated)
              occ = decorate(occ, is_cen ? strength_c : strength_s,
                             (above >> o) & 1u, is_cen, v.ceiling, A);
            acc[o] = fma(occ,
                         static_cast<double>(
                             __ldg(A.w + (size_t)(o0 + o) * A.ng + g)),
                         acc[o]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOuts; ++o) {
      if (o < n_out) {
        const int t = __ldg(A.out_table + o0 + o);
        const int i = __ldg(A.out_bin + o0 + o);
        const size_t at = A.bin_major ? (size_t)i * A.batch + b
                                      : (size_t)b * pick(A.nb, t) + i;
        pick(A.dens, t)[at] = static_cast<float>(acc[o]);
      }
    }
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
                  (A.n_units + A.units_per_block - 1) / A.units_per_block);
  occupation_kernel<FAMILY>
      <<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the occupation kernel on `stream`: the densities of `family`
// (0 Leauthaud11, 1 ZuMandelbaum15, 2 Tinker13, 3 Cacciato09; `decorated`
// adds the two strength columns) for `batch` rows of `params` ((n_params,
// batch) float32, the columns of OccArgs) over the node plan of n_units
// units of ng nodes (`node`, `res`, `first_out`, n_out outputs `out_bin`,
// `out_table`, `out_sec`, `w`, at most max_outs <= 4 a unit;
// ops/fused.py: OccupationPlan),
// `units_per_block` units a block, into the n_tables tables' `dens[t]`
// ((nb[t], batch) if `bin_major`, else (batch, nb[t])), whose first nc[t]
// bins are centrals.  Every output bin of every table must appear in the
// plan once.  `sfr` is Tinker13's designation (0 all, 1 quiescent, 2
// active) and `spline` its quiescent-fraction map (float64, on the
// device).  Returns the CUDA error code of the launch (0 on success); the
// kernel runs asynchronously.
int tabcorr_occupation(const float* params, int batch, int n_params,
                       int family, int decorated, int modulate, int sfr,
                       double threshold, double a, double log_h,
                       double split, const double* spline, int n_seg,
                       int n_coef, int n_pts, const float* node,
                       const float* res, const int* first_out,
                       const int* out_bin, const int* out_table,
                       const float* out_sec, const float* w, int n_units,
                       int n_out, int max_outs, int ng, int units_per_block,
                       int n_tables,
                       const int* nb, const int* nc, float* const* dens,
                       int bin_major, int device, void* stream) {
  const int cols = family_columns(family, n_pts);
  const bool tinker = family == kTinker13;
  bool bad =
      cols < 0 || n_params != cols + (decorated ? 2 : 0) || batch < 0 ||
      n_units <= 0 || n_out < n_units || max_outs < 1 ||
      max_outs > kMaxOuts || ng <= 0 || units_per_block <= 0 ||
      (n_units + units_per_block - 1) / units_per_block > 65535 ||
      n_tables < 1 || n_tables > kMaxTables || !nb || !nc || !dens ||
      !(split > 0.0 && split < 1.0) || (batch > 0 && !params) || !node ||
      !res || !first_out || !out_bin || !out_table || !out_sec || !w ||
      (tinker && (!spline || n_seg < 1 || n_coef < 1 ||
                  n_coef > kMaxSplineCoeffs || n_pts < 2 ||
                  n_pts > kMaxSplinePoints || sfr < kSfrAll ||
                  sfr > kSfrActive));
  for (int t = 0; !bad && t < n_tables; ++t)
    bad = nb[t] <= 0 || nc[t] < 0 || nc[t] > nb[t] || (batch > 0 && !dens[t]);
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
  A.node = node;
  A.res = res;
  A.first_out = first_out;
  A.out_bin = out_bin;
  A.out_table = out_table;
  A.out_sec = out_sec;
  A.w = w;
  A.n_units = n_units;
  A.ng = ng;
  A.units_per_block = units_per_block;
  for (int t = 0; t < n_tables; ++t) {
    A.nb[t] = nb[t];
    A.nc[t] = nc[t];
    A.dens[t] = dens[t];
  }
  A.bin_major = bin_major;
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
