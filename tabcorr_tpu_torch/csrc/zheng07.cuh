// zheng07 occupation quadrature shared by the bundle kernel (bundle.cu),
// the grid kernel (grid.cu) and the slab kernel (slab.cu), so that every
// kernel evaluates the model the same way.
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
//
// Model code 1 is zheng07 with the Heaviside assembly-bias decoration of
// tabcorr_tpu_torch/models/assembias.py (AssembiasZheng07Model): two more
// parameter columns, the strengths A_c and A_s, and per bin its secondary
// percentile.  The decoration is applied per quadrature node to the
// residual-absorbed base occupation, before the weight FMA (it is not
// linear in the base, so it cannot act on the bin's sum), with the
// expressions in the order of models/assembias.py.  Its products are
// __fmul_rn, which the compiler never contracts into an FMA, so the kernel
// rounds where the tensor version rounds.  The model code is a template
// parameter of occupation_phase(), so a zheng07 launch runs no decoration
// code: as a run-time branch it cost the occupation-bound 'efficient'
// Delta Sigma grid 18% (24.1 -> 28.4 ms, H100 80GB HBM3 at 700 W).
//
// Model code 2 (kDensityIn) is every other model: the densities n[b, i]
// come computed, (nb, B) float32 bin-major (QuadArgs::dens), by the
// occupation kernel of the HOD families (occupation.cu) or, for a model
// it does not evaluate, in tensor ops (ops/fused.py:kernel_densities),
// and occupation_phase() only loads them, consecutive threads on
// consecutive rows of one bin, so that a warp's loads are consecutive
// floats and its stores into the bin-major sN consecutive banks.  No
// parameter terms are formed.  Codes 0 and 1 compile no load and code 2
// no occupation: the branch is the same template parameter.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tabcorr {
// The quadrature loops are unrolled by 4: the nodes' evaluations are
// independent chains of ~50 dependent instructions, and four warps per
// scheduler do not hide them (the occupation-bound 'efficient' Delta Sigma
// grid: 15.1 -> 13.6 ms, the wp + xi_ell bundle 8.0 -> 7.9 ms, H100 80GB
// HBM3 at 700 W).
constexpr int kOccUnroll = 4;

// Parameter columns: logMmin, sigma_logM, logM0, logM1, alpha, then (model
// code 1) the central and satellite assembly-bias strengths.
constexpr int kZheng07 = 0;             // model codes (HodArgs::model)
constexpr int kAssembiasZheng07 = 1;
constexpr int kDensityIn = 2;
constexpr int kMaxParams = 7;
constexpr int kParTerms = 8;     // rows of sPar
constexpr float kLn10 = 2.302585092994046f;
constexpr float kRatioMax = 0.999999f;   // 1 - 1e-6, as in models/zheng07.py

// What a launch needs of the model.
struct HodArgs {
  int model;          // 0: zheng07; 1: zheng07 with Heaviside assembly
                      // bias; 2: densities in
  int n_params;       // parameter columns: 5, 7 or 0
  int modulate;       // zheng07 modulate_with_cenocc
  float split;        // the percentile split, and the three float32
  float frac_above;   // constants the tensor version derives from it in
  float ratio;        // float64: 1 - split, split / (1 - split) and the
  float edge;         // knife-edge threshold split - 1e-6
};

// HodArgs of a launch, or false for an unknown model code or split.
inline bool make_hod(int model, int modulate, double split, HodArgs* h) {
  if (model < kZheng07 || model > kDensityIn ||
      !(split > 0.0 && split < 1.0))
    return false;
  h->model = model;
  h->n_params = model == kZheng07 ? 5 : model == kAssembiasZheng07 ? 7 : 0;
  h->modulate = modulate;
  h->split = static_cast<float>(split);
  h->frac_above = static_cast<float>(1.0 - split);
  h->ratio = static_cast<float>(split / (1.0 - split));
  h->edge = static_cast<float>(split - 1e-6);
  return true;
}

// The quadrature of one table, bins ordered [centrals..., satellites...].
struct QuadArgs {
  const float* logm;    // (nb, ng) float32 node log10 mass
  const float* res;     // (nb, ng) float64 node residual, in float32
  const float* sec;     // (nb, ng) secondary percentile, the bin's midpoint
                        // at every node (read once per bin, model code 1)
  const float* w;       // (nb, ng) quad_weight * n_h
  const float* dens;    // (nb, B) densities (model code 2), else null
  int nb, nc, ng;
};

// Per-row parameter terms, sPar[kParTerms][TB]: logMmin, 1/sigma_logM,
// logM0, 10^logM0, logM1, ln10 * alpha, and the strengths A_c and A_s
// clipped to [-1, 1] (0 for zheng07).  Rows past the batch end get
// harmless values and are never stored.  Model code 2 has none.
template <int TB, int MODEL>
__device__ void param_terms(const float* params, int batch, int row0,
                            const HodArgs& h, float* sPar) {
  if constexpr (MODEL == kDensityIn) return;
  const int tid = threadIdx.x;
  if (tid < TB) {
    float p[kMaxParams] = {0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + tid < batch) {
      for (int q = 0; q < h.n_params; ++q)
        p[q] = params[(size_t)(row0 + tid) * h.n_params + q];
    }
    sPar[0 * TB + tid] = p[0];
    sPar[1 * TB + tid] = 1.0f / p[1];
    sPar[2 * TB + tid] = p[2];
    sPar[3 * TB + tid] = exp10f(p[2]);
    sPar[4 * TB + tid] = p[3];
    sPar[5 * TB + tid] = kLn10 * p[4];
    sPar[6 * TB + tid] = fminf(fmaxf(p[5], -1.f), 1.f);
    sPar[7 * TB + tid] = fminf(fmaxf(p[6], -1.f), 1.f);
  }
}

// heaviside_assembias(base, strength, sec, split, 0, upper) of
// models/assembias.py: `bounded` is upper = 1 (centrals), else no upper
// bound (satellites); `above` is sec >= split - 1e-6.
__device__ __forceinline__ float decorate(float base, float strength,
                                          bool above, bool bounded,
                                          const HodArgs& h) {
  const float head = base;   // base - lower_bound, lower_bound = 0
  float room_up, room_down;
  if (bounded) {
    room_up = fminf(1.0f - base, __fmul_rn(h.ratio, head));
    room_down = fminf(head, __fmul_rn(h.ratio, 1.0f - base));
  } else {
    room_up = __fmul_rn(h.ratio, head);
    room_down = head;
  }
  const float delta = strength >= 0.f ? __fmul_rn(strength, room_up)
                                      : __fmul_rn(strength, room_down);
  return above ? base + delta
               : base - __fmul_rn(delta, h.frac_above) / h.split;
}

// Where slab_tc (slab.cu) keeps n[b, i] of its TB rows: bin-major at a
// row stride of TB, the row index's bits 3-4 flipped by the bin's last two
// bits.  A warp's loads of the wgmma A fragments (lane (g, t) reads bin
// 8s + t (+ 4) of row g (+ 8)) and of the row totals (lane t reads bins t,
// t + 4, ...) then hit 32 banks without padding the rows, and a lane's
// flip is the same at every k-step.
template <int TB>
__device__ __forceinline__ int swizzled_index(int i, int b) {
  return i * TB + (b ^ ((i & 3) << 3));
}

// sN[i * STRIDE + b] = n[b, i] (SWIZZLED: sN[swizzled_index<TB>(i, b)]) for
// i < n_rows (bins past q.nb and rows past the batch end get 0), for the
// model code MODEL (== h.model): computed (codes 0 and 1) or loaded (code
// 2).
template <int TB, int NT, int MODEL, int STRIDE = TB, bool SWIZZLED = false>
__device__ void occupation_phase(const QuadArgs& q, int n_rows, int batch,
                                 int row0, const HodArgs& h,
                                 const float* sPar, float* sN) {
  if constexpr (MODEL == kDensityIn) {
    for (int item = threadIdx.x; item < n_rows * TB; item += NT) {
      const int i = item / TB;
      const int b = item % TB;
      sN[SWIZZLED ? swizzled_index<TB>(i, b) : i * STRIDE + b] =
          (i < q.nb && row0 + b < batch)
              ? __ldg(q.dens + (size_t)i * batch + row0 + b)
              : 0.f;
    }
    return;
  }
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
      constexpr bool decorated = MODEL == kAssembiasZheng07;
      const bool above = decorated && q.sec[(size_t)i * q.ng] >= h.edge;
      if (i < q.nc) {
        const float strength = sPar[6 * TB + b];
#pragma unroll kOccUnroll
        for (int g = 0; g < q.ng; ++g) {
          const float centered = (lm[g] - log_mmin) + rs[g];
          float ncen = 0.5f * erfcf(-centered * inv_sigma);
          if constexpr (decorated)
            ncen = decorate(ncen, strength, above, true, h);
          acc = fmaf(ncen, w[g], acc);
        }
      } else {
        const float strength = sPar[7 * TB + b];
#pragma unroll kOccUnroll
        for (int g = 0; g < q.ng; ++g) {
          const float log_m = lm[g];
          const float ratio = fminf(exp10f(-log_m) * p10_m0, kRatioMax);
          float log_pow = (log_m - log_m1) + log1pf(-ratio) / kLn10;
          log_pow = log_pow + rs[g] / (1.0f - ratio);
          float nsat = expf(ln10_alpha * log_pow);
          nsat = log_m > log_m0 ? nsat : 0.f;
          if (h.modulate) {
            const float centered = (log_m - log_mmin) + rs[g];
            nsat = nsat * (0.5f * erfcf(-centered * inv_sigma));
          }
          if constexpr (decorated)
            nsat = decorate(nsat, strength, above, false, h);
          acc = fmaf(nsat, w[g], acc);
        }
      }
    }
    if constexpr (SWIZZLED)
      sN[swizzled_index<TB>(i, b)] = acc;
    else if constexpr (STRIDE == TB)
      sN[item] = acc;   // item == i * TB + b
    else
      sN[i * STRIDE + b] = acc;
  }
}

}  // namespace tabcorr
