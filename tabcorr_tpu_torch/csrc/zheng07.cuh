// zheng07 occupation quadrature shared by the bundle kernel (bundle.cu)
// and the grid kernel (grid.cu), so that every kernel evaluates the model
// the same way.
//
// A block owns TB consecutive batch rows.  param_terms() puts each row's
// parameter terms into shared memory; occupation_phase() then computes the
// per-bin galaxy density
//
//     n[b, i] = sum_g occ(params_b, node_ig) * w[i, g],  w = quad_weight * n_h,
//
// for every (padded) bin i of the table and every row b of the block, one
// thread per (row, bin), accumulating over the bin's nodes in order with
// fmaf (deterministic, no atomics).  The expressions and their order follow
// tabcorr_tpu_torch/models/zheng07.py, the float64 node residual absorbed
// exactly as there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tabcorr {

constexpr int kParams = 5;       // logMmin, sigma_logM, logM0, logM1, alpha
constexpr float kLn10 = 2.302585092994046f;
constexpr float kRatioMax = 0.999999f;   // 1 - 1e-6, as in models/zheng07.py

// The quadrature of one table, bins ordered [centrals..., satellites...].
struct QuadArgs {
  const float* logm;    // (nb, ng) float32 node log10 mass
  const float* res;     // (nb, ng) float64 node residual, in float32
  const float* w;       // (nb, ng) quad_weight * n_h
  int nb, nc, ng;
};

// Per-row parameter terms, sPar[6][TB]: logMmin, 1/sigma_logM, logM0,
// 10^logM0, logM1, ln10 * alpha.  Rows past the batch end get harmless
// values and are never stored.
template <int TB>
__device__ void param_terms(const float* params, int batch, int row0,
                            float* sPar) {
  const int tid = threadIdx.x;
  if (tid < TB) {
    float p[kParams] = {0.f, 1.f, 0.f, 0.f, 0.f};   // masked rows
    if (row0 + tid < batch) {
      for (int q = 0; q < kParams; ++q)
        p[q] = params[(size_t)(row0 + tid) * kParams + q];
    }
    sPar[0 * TB + tid] = p[0];
    sPar[1 * TB + tid] = 1.0f / p[1];
    sPar[2 * TB + tid] = p[2];
    sPar[3 * TB + tid] = exp10f(p[2]);
    sPar[4 * TB + tid] = p[3];
    sPar[5 * TB + tid] = kLn10 * p[4];
  }
}

// sN[i * TB + b] = n[b, i] for i < n_rows (bins past q.nb and rows past
// the batch end get 0).
template <int TB, int NT>
__device__ void occupation_phase(const QuadArgs& q, int n_rows, int batch,
                                 int row0, int modulate, const float* sPar,
                                 float* sN) {
  for (int item = threadIdx.x; item < n_rows * TB; item += NT) {
    const int i = item / TB;
    const int b = item % TB;
    float acc = 0.f;
    if (i < q.nb && row0 + b < batch) {
      const float log_mmin = sPar[0 * TB + b];
      const float inv_sigma = sPar[1 * TB + b];
      const float log_m0 = sPar[2 * TB + b];
      const float p10_m0 = sPar[3 * TB + b];
      const float log_m1 = sPar[4 * TB + b];
      const float ln10_alpha = sPar[5 * TB + b];
      const float* lm = q.logm + (size_t)i * q.ng;
      const float* rs = q.res + (size_t)i * q.ng;
      const float* w = q.w + (size_t)i * q.ng;
      if (i < q.nc) {
        for (int g = 0; g < q.ng; ++g) {
          const float centered = (lm[g] - log_mmin) + rs[g];
          const float ncen = 0.5f * erfcf(-centered * inv_sigma);
          acc = fmaf(ncen, w[g], acc);
        }
      } else {
        for (int g = 0; g < q.ng; ++g) {
          const float log_m = lm[g];
          const float ratio = fminf(exp10f(-log_m) * p10_m0, kRatioMax);
          float log_pow = (log_m - log_m1) + log1pf(-ratio) / kLn10;
          log_pow = log_pow + rs[g] / (1.0f - ratio);
          float nsat = expf(ln10_alpha * log_pow);
          nsat = log_m > log_m0 ? nsat : 0.f;
          if (modulate) {
            const float centered = (log_m - log_mmin) + rs[g];
            nsat = nsat * (0.5f * erfcf(-centered * inv_sigma));
          }
          acc = fmaf(nsat, w[g], acc);
        }
      }
    }
    sN[item] = acc;   // item == i * TB + b
  }
}

}  // namespace tabcorr
