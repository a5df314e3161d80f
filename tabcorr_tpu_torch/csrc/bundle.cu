// Bundle predictor kernel for Hopper (sm_90a): zheng07 occupation
// quadrature and every table's wp / xi_ell contraction for a batch of
// parameter vectors, in one launch.
//
// Replaces: tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor (the
// Pallas TPU kernel).  It computes what that kernel computes, not its
// block structure.
//
// What bounds it on an H100: FP32 FMA.  Per parameter vector the dense
// contractions cost sum_tables n_xi * n_bins^2 multiply-adds (19 * 60^2 +
// 42 * 120^2 = 673,200 for the wp + xi_ell bundle) against ~1,800
// occupation evaluations (erfcf / exp10f / log1pf / expf, about 60-100
// instructions each), and only 20 bytes of parameters in and ~250 bytes
// of results out.  The matrices (~2.7 MB for both tables) stay in the
// 50 MB L2.
//
// What the design does about it:
// * A block owns kTB = 64 batch rows.  The per-bin densities n[b, i] of
//   those rows are computed into shared memory (one thread per (row, bin)
//   evaluates the bin's n_gauss nodes and accumulates occ * weight in
//   node order: deterministic, no atomics) and never touch device memory.
// * The contraction t[b, (k, i)] = sum_j n[b, j] F[k, i, j] is a
//   register-tiled FP32 GEMM: F is staged through shared memory in
//   kKT x kCT tiles, each thread accumulates an 8 x 4 tile (8 rows x 4
//   consecutive columns) with fmaf, so every staged F element is reused
//   by 64 rows and every n value by 128 columns.
// * The quadratic form's epilogue multiplies each thread's columns by
//   n[b, i] and reduces them per statistic k through shared memory in a
//   fixed order (deterministic), then divides by (sum_i n_i)^2 (auto) or
//   sum_i n_i (cross); that sum is accumulated in double.  Rows past
//   the batch end are masked, not padded.
// Full FP32 throughout: no tensor-core tier, no fast math (see
// utils/build.py), so every output meets the 'elementwise' contract.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTB = 64;          // batch rows per block
constexpr int kThreads = 256;    // 8 row groups x 32 column groups
constexpr int kKT = 32;          // rows (j) of F per staged tile
constexpr int kCT = 128;         // columns of F per staged tile
constexpr int kRM = 8;           // rows per thread
constexpr int kRN = 4;           // columns per thread
constexpr int kGroups = kCT / kRN;
constexpr int kMaxTables = 4;
constexpr int kParams = 5;       // logMmin, sigma_logM, logM0, logM1, alpha
constexpr int kPtrs = 6;         // per-table pointers passed from the host
constexpr int kDims = 8;         // per-table integers passed from the host
constexpr float kLn10 = 2.302585092994046f;
constexpr float kRatioMax = 0.999999f;   // 1 - 1e-6, as in models/zheng07.py

static_assert(kThreads == (kTB / kRM) * kGroups, "thread layout");

struct TableArgs {
  const float* logm;    // (nb, ng) float32 node log10 mass
  const float* res;     // (nb, ng) float64 node residual, in float32
  const float* w;       // (nb, ng) quad_weight * n_h
  const float* ft;      // (k_pad, c_pad): ft[j, k*nbp + i] = F[k, i, j]
                        // (auto) or ft[j, k] = F[k, j] (cross)
  float* out_total;     // (B,)
  float* out_xi;        // (B, n_xi)
  int nb, nc, ng, n_xi, nbp, k_pad, c_pad, is_auto;
};

struct BundleArgs {
  const float* params;  // (B, kParams)
  int batch;
  int modulate;         // zheng07 modulate_with_cenocc
  int n_tables;
  int k_pad_max;
  int nxi_max;
  TableArgs t[kMaxTables];
};

// Shared-memory layout (floats), per block:
//   sN   [k_pad_max][kTB]   per-bin densities, bin-major
//   sF   [kKT][kCT]         staged tile of ft
//   sP   [kTB][kGroups]     per-thread-column-group partial sums
//   sQ   [kTB][nxi_max]     quadratic forms / matvecs per statistic
//   sPar [6][kTB]           per-row parameter terms
//   sTot [kTB]              sum_i n_i per row
inline size_t smem_floats(int k_pad_max, int nxi_max) {
  return (size_t)k_pad_max * kTB + kKT * kCT + kTB * kGroups +
         (size_t)kTB * nxi_max + 7 * kTB;
}

// n[b, i] for every row of the tile and every (padded) bin of one table.
// The expressions and their order follow models/zheng07.py.
__device__ void occupation_phase(const TableArgs& t, int batch, int row0,
                                 int modulate, const float* sPar,
                                 float* sN) {
  for (int item = threadIdx.x; item < t.k_pad * kTB; item += kThreads) {
    const int i = item / kTB;
    const int b = item % kTB;
    float acc = 0.f;
    if (i < t.nb && row0 + b < batch) {
      const float log_mmin = sPar[0 * kTB + b];
      const float inv_sigma = sPar[1 * kTB + b];
      const float log_m0 = sPar[2 * kTB + b];
      const float p10_m0 = sPar[3 * kTB + b];
      const float log_m1 = sPar[4 * kTB + b];
      const float ln10_alpha = sPar[5 * kTB + b];
      const float* lm = t.logm + (size_t)i * t.ng;
      const float* rs = t.res + (size_t)i * t.ng;
      const float* w = t.w + (size_t)i * t.ng;
      if (i < t.nc) {
        for (int g = 0; g < t.ng; ++g) {
          const float centered = (lm[g] - log_mmin) + rs[g];
          const float ncen = 0.5f * erfcf(-centered * inv_sigma);
          acc = fmaf(ncen, w[g], acc);
        }
      } else {
        for (int g = 0; g < t.ng; ++g) {
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
    sN[item] = acc;   // item == i * kTB + b; padded bins and rows get 0
  }
}

__global__ void __launch_bounds__(kThreads)
bundle_kernel(const BundleArgs args) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sF = sN + (size_t)args.k_pad_max * kTB;
  float* sP = sF + kKT * kCT;
  float* sQ = sP + kTB * kGroups;
  float* sPar = sQ + (size_t)kTB * args.nxi_max;
  float* sTot = sPar + 6 * kTB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTB;
  const int rg = tid / kGroups;   // row group: rows rg*kRM .. +kRM-1
  const int cg = tid % kGroups;   // column group: columns cg*kRN .. +kRN-1

  // Per-row parameter terms, shared by every table.
  if (tid < kTB) {
    float p[kParams] = {0.f, 1.f, 0.f, 0.f, 0.f};   // masked rows
    if (row0 + tid < args.batch) {
      for (int q = 0; q < kParams; ++q)
        p[q] = args.params[(size_t)(row0 + tid) * kParams + q];
    }
    sPar[0 * kTB + tid] = p[0];            // logMmin
    sPar[1 * kTB + tid] = 1.0f / p[1];     // 1 / sigma_logM
    sPar[2 * kTB + tid] = p[2];            // logM0
    sPar[3 * kTB + tid] = exp10f(p[2]);    // 10^logM0
    sPar[4 * kTB + tid] = p[3];            // logM1
    sPar[5 * kTB + tid] = kLn10 * p[4];    // ln10 * alpha
  }
  __syncthreads();

  for (int ti = 0; ti < args.n_tables; ++ti) {
    const TableArgs t = args.t[ti];

    occupation_phase(t, args.batch, row0, args.modulate, sPar, sN);
    for (int item = tid; item < kTB * t.n_xi; item += kThreads)
      sQ[item] = 0.f;
    __syncthreads();
    if (tid < kTB) {
      // sum_i n_i in double: a float32 running sum over ~100 bins would
      // carry ~5e-7 relative error into xi's 1/(sum n)^2.
      double s = 0.0;
      for (int i = 0; i < t.nb; ++i) s += sN[i * kTB + tid];
      sTot[tid] = static_cast<float>(s);
    }

    const float4* sN4 = reinterpret_cast<const float4*>(sN);
    const float4* sF4 = reinterpret_cast<const float4*>(sF);
    const float4* ft4 = reinterpret_cast<const float4*>(t.ft);
    for (int ct = 0; ct < t.c_pad; ct += kCT) {
      float acc[kRM][kRN];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < kRN; ++c) acc[r][c] = 0.f;

      for (int j0 = 0; j0 < t.k_pad; j0 += kKT) {
        __syncthreads();   // the previous tile's readers are done
        for (int l = tid; l < kKT * kCT / 4; l += kThreads) {
          const int r = l / (kCT / 4);
          const int c4 = l % (kCT / 4);
          reinterpret_cast<float4*>(sF)[l] =
              __ldg(ft4 + ((size_t)(j0 + r) * t.c_pad + ct) / 4 + c4);
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kKT; ++jj) {
          const float4 a0 = sN4[(j0 + jj) * (kTB / 4) + rg * 2];
          const float4 a1 = sN4[(j0 + jj) * (kTB / 4) + rg * 2 + 1];
          const float4 f = sF4[jj * (kCT / 4) + cg];
          const float a[kRM] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
          const float fv[kRN] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int r = 0; r < kRM; ++r)
#pragma unroll
            for (int c = 0; c < kRN; ++c)
              acc[r][c] = fmaf(a[r], fv[c], acc[r][c]);
        }
      }

      if (t.is_auto) {
        // Columns ct + cg*4 .. +3 are (k, i0 .. i0+3) of one statistic k.
        const int col = ct + cg * kRN;
        const int k = col / t.nbp;
        const int i0 = col - k * t.nbp;
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int b = rg * kRM + r;
          float s = 0.f;
          if (k < t.n_xi) {
#pragma unroll
            for (int c = 0; c < kRN; ++c)
              s = fmaf(acc[r][c], sN[(i0 + c) * kTB + b], s);
          }
          sP[b * kGroups + cg] = s;
        }
        __syncthreads();
        // One thread per (row, statistic) of this column tile sums its
        // column groups in order.
        const int k_lo = ct / t.nbp;
        const int k_hi = min((ct + kCT - 1) / t.nbp, t.n_xi - 1);
        const int nk = k_hi - k_lo + 1;
        for (int item = tid; item < kTB * nk; item += kThreads) {
          const int b = item / nk;
          const int kk = k_lo + item % nk;
          const int g_lo = max(kk * t.nbp - ct, 0) / kRN;
          const int g_hi = min((kk + 1) * t.nbp - ct, kCT) / kRN;
          float s = 0.f;
          for (int g = g_lo; g < g_hi; ++g) s += sP[b * kGroups + g];
          sQ[b * t.n_xi + kk] += s;
        }
        // The next tile writes sP only after the __syncthreads() at the
        // top of its j0 loop.
      } else {
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int c = 0; c < kRN; ++c) {
            const int k = ct + cg * kRN + c;
            if (k < t.n_xi) sQ[(rg * kRM + r) * t.n_xi + k] = acc[r][c];
          }
      }
    }
    __syncthreads();

    for (int item = tid; item < kTB * t.n_xi; item += kThreads) {
      const int b = item / t.n_xi;
      if (row0 + b < args.batch) {
        const float tot = sTot[b];
        t.out_xi[(size_t)row0 * t.n_xi + item] =
            t.is_auto ? sQ[item] / (tot * tot) : sQ[item] / tot;
      }
    }
    if (tid < kTB && row0 + tid < args.batch)
      t.out_total[row0 + tid] = sTot[tid];
    __syncthreads();   // before the next table reuses sN, sQ and sTot
  }
}

}  // namespace

extern "C" {

// Launch the bundle kernel on `stream`.  Per table, `ptrs` holds
// (logm, res, w, ft, out_total, out_xi) and `dims` holds
// (nb, nc, ng, n_xi, nbp, k_pad, c_pad, is_auto).  Returns the CUDA error
// code of the launch (0 on success); the kernel runs asynchronously.
int tabcorr_bundle(const float* params, int batch, int modulate,
                   int n_tables, void* const* ptrs, const int* dims,
                   int device, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || batch < 0)
    return (int)cudaErrorInvalidValue;
  BundleArgs args = {};
  args.params = params;
  args.batch = batch;
  args.modulate = modulate;
  args.n_tables = n_tables;
  for (int ti = 0; ti < n_tables; ++ti) {
    void* const* p = ptrs + ti * kPtrs;
    const int* d = dims + ti * kDims;
    TableArgs& t = args.t[ti];
    t.logm = static_cast<const float*>(p[0]);
    t.res = static_cast<const float*>(p[1]);
    t.w = static_cast<const float*>(p[2]);
    t.ft = static_cast<const float*>(p[3]);
    t.out_total = static_cast<float*>(p[4]);
    t.out_xi = static_cast<float*>(p[5]);
    t.nb = d[0];
    t.nc = d[1];
    t.ng = d[2];
    t.n_xi = d[3];
    t.nbp = d[4];
    t.k_pad = d[5];
    t.c_pad = d[6];
    t.is_auto = d[7];
    if (t.nbp % kRN || t.k_pad % kKT || t.c_pad % kCT || t.k_pad < t.nbp ||
        t.nbp < t.nb || t.n_xi < 1 || t.nc < 0 || t.nc > t.nb)
      return (int)cudaErrorInvalidValue;
    args.k_pad_max = t.k_pad > args.k_pad_max ? t.k_pad : args.k_pad_max;
    args.nxi_max = t.n_xi > args.nxi_max ? t.n_xi : args.nxi_max;
  }
  const size_t smem = smem_floats(args.k_pad_max, args.nxi_max) *
                      sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bundle_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  const int grid = (batch + kTB - 1) / kTB;
  bundle_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
