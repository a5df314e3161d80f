// Bundle predictor kernel (B1) and contraction kernel (B3) for Hopper
// (sm_90a).
//
// bundle_kernel: zheng07 occupation quadrature and every table's wp /
// xi_ell contraction for a batch of parameter vectors, in one launch.
// Replaces tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor.
//
// contraction_kernel: the same contraction for one table, with the
// per-bin densities n[b, i] read from device memory instead of computed
// (any occupation model, evaluated beforehand in tensor ops).  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_contraction (wrapped there by
// make_fused_predictor).  It is its own launch.
//
// Both compute what the Pallas kernels compute, not their block
// structure.
//
// What bounds them on an H100: FP32 FMA.  Per parameter vector the dense
// contractions cost sum_tables n_xi * n_bins^2 multiply-adds (19 * 60^2 +
// 42 * 120^2 = 673,200 for the wp + xi_ell bundle) against ~1,800
// occupation evaluations (erfcf / exp10f / log1pf / expf, about 60-100
// instructions each), and only 20 bytes of parameters (B3: 4 bytes per
// bin) in and ~250 bytes of results out.  The matrices (~2.7 MB for both
// tables) stay in the 50 MB L2.
//
// What the design does about it:
// * A block owns kTB = 64 batch rows.  The per-bin densities of those rows
//   sit in shared memory (B1 computes them there with the occupation of
//   zheng07.cuh; B3 loads them) and are reused by every column.
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

#include "zheng07.cuh"

namespace {

using tabcorr::QuadArgs;

constexpr int kTB = 64;          // batch rows per block
constexpr int kThreads = 256;    // 8 row groups x 32 column groups
constexpr int kKT = 32;          // rows (j) of F per staged tile
constexpr int kCT = 128;         // columns of F per staged tile
constexpr int kRM = 8;           // rows per thread
constexpr int kRN = 4;           // columns per thread
constexpr int kGroups = kCT / kRN;
constexpr int kMaxTables = 4;
constexpr int kPtrs = 6;         // per-table pointers passed from the host
constexpr int kDims = 8;         // per-table integers passed from the host

static_assert(kThreads == (kTB / kRM) * kGroups, "thread layout");

struct TableArgs {
  QuadArgs q;           // occupation quadrature (bundle_kernel only)
  const float* ft;      // (k_pad, c_pad): ft[j, k*nbp + i] = F[k, i, j]
                        // (auto) or ft[j, k] = F[k, j] (cross)
  float* out_total;     // (B,)
  float* out_xi;        // (B, n_xi)
  int nb, n_xi, nbp, k_pad, c_pad, is_auto;
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
//   sPar [6][kTB]           per-row parameter terms (bundle_kernel)
//   sTot [kTB]              sum_i n_i per row
inline size_t smem_floats(int k_pad_max, int nxi_max) {
  return (size_t)k_pad_max * kTB + kKT * kCT + kTB * kGroups +
         (size_t)kTB * nxi_max + 7 * kTB;
}

struct Smem {
  float* sN;
  float* sF;
  float* sP;
  float* sQ;
  float* sPar;
  float* sTot;
};

__device__ Smem carve(float* base, int k_pad_max, int nxi_max) {
  Smem s;
  s.sN = base;
  s.sF = s.sN + (size_t)k_pad_max * kTB;
  s.sP = s.sF + kKT * kCT;
  s.sQ = s.sP + kTB * kGroups;
  s.sPar = s.sQ + (size_t)kTB * nxi_max;
  s.sTot = s.sPar + 6 * kTB;
  return s;
}

// xi and sum_i n_i of one table for the block's rows.  On entry s.sN holds
// n[b, i] bin-major (0 for padded bins and masked rows) and a
// __syncthreads() has passed since it was written; on exit the outputs are
// stored and the block is synchronised, so sN may be overwritten.
__device__ void contract_table(const TableArgs& t, int batch, int row0,
                               const Smem& s) {
  const int tid = threadIdx.x;
  const int rg = tid / kGroups;   // row group: rows rg*kRM .. +kRM-1
  const int cg = tid % kGroups;   // column group: columns cg*kRN .. +kRN-1
  float* sN = s.sN;
  float* sF = s.sF;
  float* sP = s.sP;
  float* sQ = s.sQ;

  for (int item = tid; item < kTB * t.n_xi; item += kThreads) sQ[item] = 0.f;
  if (tid < kTB) {
    // sum_i n_i in double: a float32 running sum over ~100 bins would
    // carry ~5e-7 relative error into xi's 1/(sum n)^2.
    double sum = 0.0;
    for (int i = 0; i < t.nb; ++i) sum += sN[i * kTB + tid];
    s.sTot[tid] = static_cast<float>(sum);
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
        float v = 0.f;
        if (k < t.n_xi) {
#pragma unroll
          for (int c = 0; c < kRN; ++c)
            v = fmaf(acc[r][c], sN[(i0 + c) * kTB + b], v);
        }
        sP[b * kGroups + cg] = v;
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
        float v = 0.f;
        for (int g = g_lo; g < g_hi; ++g) v += sP[b * kGroups + g];
        sQ[b * t.n_xi + kk] += v;
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
    if (row0 + b < batch) {
      const float tot = s.sTot[b];
      t.out_xi[(size_t)row0 * t.n_xi + item] =
          t.is_auto ? sQ[item] / (tot * tot) : sQ[item] / tot;
    }
  }
  if (tid < kTB && row0 + tid < batch) t.out_total[row0 + tid] = s.sTot[tid];
  __syncthreads();   // before the caller reuses sN, sQ and sTot
}

__global__ void __launch_bounds__(kThreads)
bundle_kernel(const BundleArgs args) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), args.k_pad_max,
                       args.nxi_max);
  const int row0 = blockIdx.x * kTB;

  // Per-row parameter terms, shared by every table.
  tabcorr::param_terms<kTB>(args.params, args.batch, row0, s.sPar);
  __syncthreads();

  for (int ti = 0; ti < args.n_tables; ++ti) {
    const TableArgs t = args.t[ti];
    tabcorr::occupation_phase<kTB, kThreads>(t.q, t.k_pad, args.batch, row0,
                                             args.modulate, s.sPar, s.sN);
    __syncthreads();
    contract_table(t, args.batch, row0, s);
  }
}

__global__ void __launch_bounds__(kThreads)
contraction_kernel(const float* ngal, int batch, const TableArgs t) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), t.k_pad, t.n_xi);
  const int row0 = blockIdx.x * kTB;
  // Bin-fastest reads of the (B, nb) rows; padded bins and rows get 0.
  for (int item = threadIdx.x; item < kTB * t.k_pad; item += kThreads) {
    const int b = item / t.k_pad;
    const int i = item % t.k_pad;
    s.sN[i * kTB + b] = (i < t.nb && row0 + b < batch)
                            ? __ldg(ngal + (size_t)(row0 + b) * t.nb + i)
                            : 0.f;
  }
  __syncthreads();
  contract_table(t, batch, row0, s);
}

bool check_table(const TableArgs& t) {
  return !(t.nbp % kRN || t.k_pad % kKT || t.c_pad % kCT ||
           t.k_pad < t.nbp || t.nbp < t.nb || t.n_xi < 1 || t.nb < 1);
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
    t.q.logm = static_cast<const float*>(p[0]);
    t.q.res = static_cast<const float*>(p[1]);
    t.q.w = static_cast<const float*>(p[2]);
    t.ft = static_cast<const float*>(p[3]);
    t.out_total = static_cast<float*>(p[4]);
    t.out_xi = static_cast<float*>(p[5]);
    t.nb = t.q.nb = d[0];
    t.q.nc = d[1];
    t.q.ng = d[2];
    t.n_xi = d[3];
    t.nbp = d[4];
    t.k_pad = d[5];
    t.c_pad = d[6];
    t.is_auto = d[7];
    if (!check_table(t) || t.q.nc < 0 || t.q.nc > t.nb)
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

// Launch the contraction kernel on `stream` for one table: `ngal` is the
// contiguous (batch, nb) float32 density, `ft` the table's matrix in the
// bundle layout.  Returns the CUDA error code of the launch.
int tabcorr_contraction(const float* ngal, int batch, const float* ft,
                        float* out_total, float* out_xi, int nb, int n_xi,
                        int nbp, int k_pad, int c_pad, int is_auto,
                        int device, void* stream) {
  TableArgs t = {};
  t.ft = ft;
  t.out_total = out_total;
  t.out_xi = out_xi;
  t.nb = nb;
  t.n_xi = n_xi;
  t.nbp = nbp;
  t.k_pad = k_pad;
  t.c_pad = c_pad;
  t.is_auto = is_auto;
  if (batch < 0 || !check_table(t)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(k_pad, n_xi) * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(contraction_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0) return 0;
  const int grid = (batch + kTB - 1) / kTB;
  contraction_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(ngal, batch, t);
  return (int)cudaGetLastError();
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
