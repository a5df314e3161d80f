// Bundle predictor kernel (B1) and contraction kernel (B3) for Hopper
// (sm_90a).
//
// bundle_kernel: zheng07 occupation quadrature (optionally with the
// Heaviside assembly-bias decoration) and every table's wp / xi_ell
// contraction for a batch of parameter vectors, in one launch.  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor.
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
// instructions each), and only 20-28 bytes of parameters (B3: 4 bytes per
// bin) in and ~250 bytes of results out.  The matrices (~2.7 MB for both
// tables) stay in the 50 MB L2.
//
// What the design does about it: a block owns kTB = 64 batch rows.  The
// per-bin densities of those rows sit in shared memory (B1 computes them
// there with the occupation of zheng07.cuh; B3 loads them) and are reused
// by every column of the register-tiled contraction of contract.cuh.
// Full FP32 throughout: no tensor-core tier, no fast math (see
// utils/build.py), so every output meets the 'elementwise' contract.

#include <cuda_runtime.h>
#include <math.h>

#include "contract.cuh"

namespace {

using namespace tabcorr;

constexpr int kMaxTables = 4;
constexpr int kPtrs = 7;         // per-table pointers passed from the host
constexpr int kDims = 8;         // per-table integers passed from the host

struct BundleArgs {
  const float* params;  // (B, hod.n_params)
  int batch;
  HodArgs hod;
  int n_tables;
  int k_pad_max;
  int nxi_max;
  TableArgs t[kMaxTables];
};

template <int MODEL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bundle_kernel(const BundleArgs args) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), args.k_pad_max,
                       args.nxi_max);
  const int row0 = blockIdx.x * kTB;

  // Per-row parameter terms, shared by every table.
  param_terms<kTB>(args.params, args.batch, row0, args.hod, s.sPar);
  __syncthreads();

  for (int ti = 0; ti < args.n_tables; ++ti) {
    const TableArgs t = args.t[ti];
    occupation_phase<kTB, kThreads, MODEL>(t.q, t.k_pad, args.batch, row0,
                                           args.hod, s.sPar, s.sN);
    __syncthreads();
    contract_table(t, args.batch, row0, s);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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

template <int MODEL>
int launch_bundle(const BundleArgs& args, int device, void* stream) {
  const size_t smem = smem_floats(args.k_pad_max, args.nxi_max) *
                      sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bundle_kernel<MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (args.batch == 0) return 0;
  const int grid = (args.batch + kTB - 1) / kTB;
  bundle_kernel<MODEL><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the bundle kernel on `stream`.  `model`, `modulate` and `split`
// select the occupation (zheng07.cuh).  Per table, `ptrs` holds
// (logm, res, sec, w, ft, out_total, out_xi) and `dims` holds
// (nb, nc, ng, n_xi, nbp, k_pad, c_pad, is_auto).  Returns the CUDA error
// code of the launch (0 on success); the kernel runs asynchronously.
int tabcorr_bundle(const float* params, int batch, int model, int modulate,
                   double split, int n_tables, void* const* ptrs,
                   const int* dims, int device, void* stream) {
  if (n_tables < 1 || n_tables > kMaxTables || batch < 0)
    return (int)cudaErrorInvalidValue;
  BundleArgs args = {};
  args.params = params;
  args.batch = batch;
  if (!make_hod(model, modulate, split, &args.hod))
    return (int)cudaErrorInvalidValue;
  args.n_tables = n_tables;
  for (int ti = 0; ti < n_tables; ++ti) {
    void* const* p = ptrs + ti * kPtrs;
    const int* d = dims + ti * kDims;
    TableArgs& t = args.t[ti];
    t.q.logm = static_cast<const float*>(p[0]);
    t.q.res = static_cast<const float*>(p[1]);
    t.q.sec = static_cast<const float*>(p[2]);
    t.q.w = static_cast<const float*>(p[3]);
    t.ft = static_cast<const float*>(p[4]);
    t.out_total = static_cast<float*>(p[5]);
    t.out_xi = static_cast<float*>(p[6]);
    t.nb = t.q.nb = d[0];
    t.q.nc = d[1];
    t.q.ng = d[2];
    t.n_xi = t.out_stride = d[3];
    t.nbp = d[4];
    t.k_pad = d[5];
    t.c_pad = d[6];
    t.is_auto = d[7];
    if (!check_table(t) || t.q.nc < 0 || t.q.nc > t.nb || t.q.ng < 1)
      return (int)cudaErrorInvalidValue;
    args.k_pad_max = t.k_pad > args.k_pad_max ? t.k_pad : args.k_pad_max;
    args.nxi_max = t.n_xi > args.nxi_max ? t.n_xi : args.nxi_max;
  }
  return args.hod.model == kZheng07
             ? launch_bundle<kZheng07>(args, device, stream)
             : launch_bundle<kAssembiasZheng07>(args, device, stream);
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
  t.n_xi = t.out_stride = n_xi;
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
