// Bundle predictor kernel (B1) and contraction kernel (B3) for Hopper
// (sm_90a).
//
// bundle_kernel: zheng07 occupation quadrature (optionally with the
// Heaviside assembly-bias decoration), or for any other model the
// per-table densities computed beforehand by the occupation kernel
// (occupation.cu) or in tensor ops (model code 2, zheng07.cuh), and
// every table's wp / xi_ell contraction for a batch of parameter vectors,
// in one launch.  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor.  Every table runs
// in FP32 on the CUDA cores, under both accuracy contracts: the Pallas
// kernel drops MXU passes for rows under the 'scaled' contract, but here a
// 3xTF32 mma.sync contraction (the one slab_tc ran before it moved to
// wgmma) was slower than the FP32 one at these shapes, and less exact.
//
// contraction_kernel: the FP32 contraction for one table, with the
// per-bin densities n[b, i] read from device memory instead of computed
// (any occupation model, evaluated beforehand in tensor ops).  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_contraction (wrapped there by
// make_fused_predictor).  It is its own launch.
//
// Both compute what the Pallas kernels compute, not their block structure.
//
// What bounds them on an H100: FP32 FMA.  Per parameter vector the contractions cost
// sum_tables n_xi * n_bins (n_bins + 1) / 2 multiply-adds over the
// symmetric half (19 * 1830 + 42 * 7260 = 339,690 for the wp + xi_ell
// bundle) against ~1,800 occupation evaluations (erfcf / exp10f / log1pf /
// expf, about 60-100 instructions each), and only 20-28 bytes of
// parameters (B3: 4 bytes per bin) in and ~250 bytes of results out.  The
// matrices (~1.5 MB for both tables in the half layout) stay in the 50 MB
// L2.
//
// What the design does about it: a block owns 64 batch rows.  The per-bin
// densities of those rows sit in shared memory (B1 computes them there with the occupation of
// zheng07.cuh; B3 loads them) and are reused by every column of the
// contraction of contract.cuh, which multiplies only the block-triangular
// half of each symmetric matrix, streams it through a cp.async ring and
// reduces the quadratic form by the layout, without a barrier per column
// tile.  No fast math (see utils/build.py): the results meet the
// 'elementwise' contract, the stricter of the two.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "contract.cuh"

namespace {

using namespace tabcorr;

constexpr int kMaxTables = 4;
constexpr int kPtrs = 13;        // per-table pointers passed from the host
constexpr int kDims = 6;         // per-table integers passed from the host

struct BundleTable {
  QuadArgs q;
  HalfTable h;
  TableOut out;
};

struct BundleArgs {
  const float* params;  // (B, hod.n_params); null for model code 2
  int batch;
  HodArgs hod;
  int n_tables;
  int nb8_max;          // over the tables
  int nxi_max;
  int stage_steps;      // the ring stage, in K steps
  BundleTable t[kMaxTables];
};

// Shared-memory layout (floats), per block: sN [nb8_max][TB], the ring,
// sXi [TB][nxi_max], sPar [kParTerms][TB], sTot [TB]
// (contract.cuh:fp32_smem_floats).
template <int TB, int MODEL>
__global__ void __launch_bounds__(2 * TB, kMinBlocks)
bundle_kernel(const BundleArgs args) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sRing = sN + (size_t)args.nb8_max * TB;
  float* sXi = sRing + kStages * args.stage_steps * 8 * kCT;
  float* sPar = sXi + (size_t)TB * args.nxi_max;
  float* sTot = sPar + kParTerms * TB;
  const int row0 = blockIdx.x * TB;

  // Per-row parameter terms, shared by every table.
  param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();

  for (int ti = 0; ti < args.n_tables; ++ti) {
    const BundleTable& t = args.t[ti];
    occupation_phase<TB, 2 * TB, MODEL>(t.q, t.h.nb8, args.batch, row0,
                                        args.hod, sPar, sN);
    __syncthreads();
    contract_fp32<TB>(t.h, t.out, args.batch, row0, args.stage_steps,
                          sN, sRing, sXi, sTot);
  }
}

template <int TB>
__global__ void __launch_bounds__(2 * TB, kMinBlocks)
contraction_kernel(const float* ngal, int batch, int stage_steps,
                   const HalfTable h, const TableOut out) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sRing = sN + (size_t)h.nb8 * TB;
  float* sXi = sRing + kStages * stage_steps * 8 * kCT;
  float* sTot = sXi + (size_t)TB * h.n_xi + kParTerms * TB;
  const int row0 = blockIdx.x * TB;
  // Bin-fastest reads of the (B, nb) rows; padded bins and rows get 0.
  for (int item = threadIdx.x; item < TB * h.nb8; item += 2 * TB) {
    const int b = item / h.nb8;
    const int i = item % h.nb8;
    sN[i * TB + b] = (i < h.nb && row0 + b < batch)
                         ? __ldg(ngal + (size_t)(row0 + b) * h.nb + i)
                         : 0.f;
  }
  __syncthreads();
  contract_fp32<TB>(h, out, batch, row0, stage_steps, sN, sRing, sXi,
                        sTot);
}

// Set the kernel's dynamic shared memory and launch it over `batch` rows
// in blocks of `tb`.
template <class Kernel, class... Args>
int launch_rows(Kernel kernel, int batch, int tb, int threads, size_t smem,
                int device, void* stream, const Args&... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (batch == 0) return 0;
  kernel<<<(batch + tb - 1) / tb, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// The launch arguments from the host's per-table lists: `ptrs` holds
// (logm, res, sec, w, b, ct_step0, ct_steps, ct_off, col_k, col_i0,
// out_total, out_xi, dens) and `dims` (nb, nc, ng, n_xi, n_ct, is_auto)
// per table; `dens` is the table's (nb, B) densities for model code 2,
// else null, and `params` null for code 2.  False for what the kernel
// does not take.
bool make_bundle_args(const float* params, int batch, int model,
                      int modulate, double split, int n_tables,
                      void* const* ptrs, const int* dims, BundleArgs* args) {
  if (n_tables < 1 || n_tables > kMaxTables || batch < 0) return false;
  *args = {};
  args->params = params;
  args->batch = batch;
  if (!make_hod(model, modulate, split, &args->hod) ||
      (args->hod.model == kDensityIn) != (params == nullptr))
    return false;
  args->n_tables = n_tables;
  for (int ti = 0; ti < n_tables; ++ti) {
    void* const* p = ptrs + ti * kPtrs;
    const int* d = dims + ti * kDims;
    BundleTable& t = args->t[ti];
    t.q.logm = static_cast<const float*>(p[0]);
    t.q.res = static_cast<const float*>(p[1]);
    t.q.sec = static_cast<const float*>(p[2]);
    t.q.w = static_cast<const float*>(p[3]);
    t.h.b = static_cast<const float*>(p[4]);
    t.h.ct_step0 = static_cast<const int*>(p[5]);
    t.h.ct_steps = static_cast<const int*>(p[6]);
    t.h.ct_off = static_cast<const int*>(p[7]);
    t.h.col_k = static_cast<const int*>(p[8]);
    t.h.col_i0 = static_cast<const int*>(p[9]);
    t.out.total = static_cast<float*>(p[10]);
    t.out.xi = static_cast<float*>(p[11]);
    t.q.dens = static_cast<const float*>(p[12]);
    if ((args->hod.model == kDensityIn) != (t.q.dens != nullptr))
      return false;
    t.q.nb = t.h.nb = d[0];
    t.q.nc = d[1];
    t.q.ng = d[2];
    t.h.n_xi = d[3];
    t.out.stride = d[3];
    t.h.n_ct = d[4];
    t.h.is_auto = d[5];
    t.h.n_nodes = 1;
    t.h.nb8 = (t.h.nb + 7) / 8 * 8;
    if (!check_half_table(t.h, &t.q)) return false;
    args->nb8_max = std::max(args->nb8_max, t.h.nb8);
    args->nxi_max = std::max(args->nxi_max, t.h.n_xi);
  }
  return true;
}

}  // namespace

extern "C" {

// Launch the bundle kernel on `stream`.  `model`, `modulate` and `split`
// select the occupation (zheng07.cuh; code 2 reads each table's densities
// and no `params`); `ptrs` and `dims` hold the tables
// (make_bundle_args), their matrices in the layout of
// ops/fused.py:slab_tc_table_constants with one node.  `stage_steps` is the
// ring stage in K steps of 8 rows (contract.cuh:fp32_stage_ok).
// Returns the CUDA error code of the launch (0 on success); the kernel
// runs asynchronously.
int tabcorr_bundle(const float* params, int batch, int model, int modulate,
                   double split, int n_tables, void* const* ptrs,
                   const int* dims, int stage_steps, int device,
                   void* stream) {
  BundleArgs args;
  if (!make_bundle_args(params, batch, model, modulate, split, n_tables,
                        ptrs, dims, &args) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  args.stage_steps = stage_steps;
  constexpr int TB = 64;
  const size_t smem = fp32_smem_floats(TB, stage_steps, args.nb8_max,
                                       args.nxi_max) * sizeof(float);
  switch (args.hod.model) {
    case kZheng07:
      return launch_rows(bundle_kernel<TB, kZheng07>, batch, TB, 2 * TB,
                         smem, device, stream, args);
    case kAssembiasZheng07:
      return launch_rows(bundle_kernel<TB, kAssembiasZheng07>, batch, TB,
                         2 * TB, smem, device, stream, args);
    default:
      return launch_rows(bundle_kernel<TB, kDensityIn>, batch, TB, 2 * TB,
                         smem, device, stream, args);
  }
}

// Launch the contraction kernel on `stream` for one table: `ngal` is the
// contiguous (batch, nb) float32 density, the matrix in the bundle's
// layout.  Returns the CUDA error code of the launch.
int tabcorr_contraction(const float* ngal, int batch, const float* b,
                        const int* ct_step0, const int* ct_steps,
                        const int* ct_off, const int* col_k,
                        const int* col_i0, int n_ct, int nb, int n_xi,
                        int is_auto, int stage_steps, float* out_total,
                        float* out_xi, int device, void* stream) {
  HalfTable h = {};
  h.b = b;
  h.ct_step0 = ct_step0;
  h.ct_steps = ct_steps;
  h.ct_off = ct_off;
  h.col_k = col_k;
  h.col_i0 = col_i0;
  h.n_nodes = 1;
  h.n_xi = n_xi;
  h.n_ct = n_ct;
  h.is_auto = is_auto;
  h.nb = nb;
  h.nb8 = (nb + 7) / 8 * 8;
  const TableOut out = {out_total, out_xi, (size_t)n_xi};
  if (batch < 0 || !check_half_table(h, nullptr) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  constexpr int TB = 64;
  const size_t smem =
      fp32_smem_floats(TB, stage_steps, h.nb8, n_xi) * sizeof(float);
  return launch_rows(contraction_kernel<TB>, batch, TB, 2 * TB, smem, device,
                     stream, ngal, batch, stage_steps, h, out);
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
