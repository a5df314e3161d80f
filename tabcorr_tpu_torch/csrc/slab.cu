// Slab grid kernels (B4) for Hopper (sm_90a): every node of a stacked
// Interpolator grid of one halo binning, per node and without the spline,
// for a batch of parameter vectors.
//
// Replace: tabcorr_tpu/ops/fused.py:make_fused_grid_predictor with
// layout='slab' (the node-streamed slab kernel; tabcorr_tpu's route for
// auto grids whose packed pair row exceeds 8192 lanes, i.e. more than 127
// bins).  They compute what that kernel computes, not its block structure:
//
//   n[b, i]            zheng07 occupation quadrature, optionally with the
//                      Heaviside assembly-bias decoration (zheng07.cuh),
//                      once per row, or for any other model (code 2)
//                      read from densities computed beforehand
//                      (occupation.cu or tensor ops);
//   xi[b, node, k]   = n_b^T F_node,k n_b / (sum_i n_bi)^2   (auto)
//                    = (F_node n_b)_k / sum_i n_bi           (cross)
//
// The grid spline runs afterwards in tensor ops (predictor.py), as
// tabcorr_tpu's XLA spline follows its slab kernel.
//
// slab_kernel is the 'elementwise' tier (FP32 on the CUDA cores),
// slab_tc_kernel the 'scaled' tier (3xTF32 on the tensor cores).  Both
// read the node matrices in one layout, the block-triangular half of
// contract.cuh (ops/fused.py:slab_tc_table_constants).
//
// What bounds them on an H100: FP32 FMA (slab_kernel), the tensor cores'
// issue rate through mma.sync (slab_tc_kernel).  At the 64-node wide grid
// (160 bins, 42 rows per node) a parameter vector costs 64 x 42 x 12,880
// = 3.5e7 multiply-adds over the symmetric half against 1,600 occupation
// evaluations, with 28 bytes of parameters in and 10,756 bytes out.  The
// 147 MB of node matrices do not fit in the 50 MB L2, but the blocks in
// flight walk the nodes in the same order at about the same pace, so each
// node's 2.3 MB is read from device memory about once per wave of blocks
// (~0.2 ms of HBM time for all of them).
//
// What the design does about it:
// * A block owns 64 batch rows (32 in slab_tc where its split copies do
//   not fit).  Their densities are computed into shared memory once (40 KB
//   at 160 bins) and reused by every node.
// * The nodes run through contract.cuh's contraction as one stream of
//   column tiles: contract_fp32() (8 x 8 register tiles, fmaf) or
//   contract_tc() (mma.sync), the cp.async ring running on across node
//   boundaries; sums run over nb = 160 terms, short enough for float32
//   (tabcorr_tpu's packed form would sum 12,880 pair terms per column).
// * Each node's 64 x 42 statistics go from shared memory straight to
//   device memory: the block's whole output (64 x 2688 floats) would not
//   fit in shared memory.  No bf16 pass groups, no 128-lane packing, no
//   row permutation.

#include <cuda_runtime.h>
#include <math.h>

#include "contract.cuh"

namespace {

using namespace tabcorr;

struct SlabArgs {
  const float* params;   // (B, hod.n_params); code 2: unread (q.dens)
  int batch;
  HodArgs hod;
  QuadArgs q;
  HalfTable h;           // the n_nodes nodes' matrices
  TableOut out;          // total (B,), xi (B, n_nodes, n_xi)
  int stage_steps;       // slab_kernel's ring stage, in K steps
};

// Shared-memory layout (floats), per block: sN [nb8][TB], the ring, sXi
// [TB][n_xi], sPar [kParTerms][TB], sTot [TB]
// (contract.cuh:fp32_smem_floats).
template <int TB, int MODEL>
__global__ void __launch_bounds__(2 * TB, kMinBlocksSlab)
slab_kernel(const SlabArgs args) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sRing = sN + (size_t)args.h.nb8 * TB;
  float* sXi = sRing + kStages * args.stage_steps * 8 * kCT;
  float* sPar = sXi + (size_t)TB * args.h.n_xi;
  float* sTot = sPar + kParTerms * TB;
  const int row0 = blockIdx.x * TB;

  param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  occupation_phase<TB, 2 * TB, MODEL>(args.q, args.h.nb8, args.batch, row0,
                                      args.hod, sPar, sN);
  __syncthreads();
  contract_fp32<TB>(args.h, args.out, args.batch, row0, args.stage_steps,
                        sN, sRing, sXi, sTot);
}

// The same function on the tensor cores, in contract_tc's shared-memory
// layout (contract.cuh:TcBlock).
template <int TB, bool PRESPLIT, int MODEL>
__global__ void __launch_bounds__(tc::kThreads, 1)
slab_tc_kernel(const SlabArgs args) {
  using S = TcBlock<TB, PRESPLIT>;
  constexpr int SN = S::kStride;
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sAh = sN + (size_t)args.h.nb8 * SN;
  float* sAl = sAh + (PRESPLIT ? (size_t)args.h.nb8 * TB : 0);
  float* sB = sAl + (PRESPLIT ? (size_t)args.h.nb8 * TB : 0);
  float* sXi = sB + kStages * kTcStageFloats;
  float* sPar = sXi + (size_t)TB * args.h.n_xi;
  float* sTot = sPar + kParTerms * TB;
  const int row0 = blockIdx.x * TB;

  param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  occupation_phase<TB, tc::kThreads, MODEL, SN>(args.q, args.h.nb8,
                                                args.batch, row0, args.hod,
                                                sPar, sN);
  __syncthreads();
  contract_tc<TB, PRESPLIT>(args.h, args.out, args.batch, row0, sN, sAh, sAl,
                            sB, sXi, sTot);
}

// Set the kernel's dynamic shared memory and launch it over the batch in
// blocks of `tb` rows.
template <class Kernel>
int launch_slab(Kernel kernel, const SlabArgs& args, int tb, int threads,
                size_t smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  kernel<<<(args.batch + tb - 1) / tb, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

template <int TB, bool PRESPLIT>
int launch_slab_tc(const SlabArgs& args, int device, void* stream) {
  const size_t smem =
      TcBlock<TB, PRESPLIT>::smem_floats(args.h.nb8, args.h.n_xi) *
      sizeof(float);
  switch (args.hod.model) {
    case kZheng07:
      return launch_slab(slab_tc_kernel<TB, PRESPLIT, kZheng07>, args, TB,
                         tc::kThreads, smem, device, stream);
    case kAssembiasZheng07:
      return launch_slab(slab_tc_kernel<TB, PRESPLIT, kAssembiasZheng07>,
                         args, TB, tc::kThreads, smem, device, stream);
    default:
      return launch_slab(slab_tc_kernel<TB, PRESPLIT, kDensityIn>, args, TB,
                         tc::kThreads, smem, device, stream);
  }
}

// The launch arguments of both kernels; false for what they do not take.
bool make_slab_args(const float* params, int batch, int model, int modulate,
                    double split, const float* logm, const float* res,
                    const float* sec, const float* w, int nb, int nc, int ng,
                    const float* b, long long node_stride,
                    const int* ct_step0, const int* ct_steps,
                    const int* ct_off, const int* col_k, const int* col_i0,
                    int n_ct, int n_nodes, int n_xi, int is_auto,
                    float* out_total, float* out_xi, SlabArgs* args) {
  *args = {};
  args->params = params;
  args->batch = batch;
  args->q.logm = logm;
  args->q.res = res;
  args->q.sec = sec;
  args->q.w = w;
  args->q.dens = model == kDensityIn ? params : nullptr;
  args->q.nb = nb;
  args->q.nc = nc;
  args->q.ng = ng;
  HalfTable& h = args->h;
  h.b = b;
  h.ct_step0 = ct_step0;
  h.ct_steps = ct_steps;
  h.ct_off = ct_off;
  h.col_k = col_k;
  h.col_i0 = col_i0;
  h.node_stride = (size_t)node_stride;
  h.n_nodes = n_nodes;
  h.n_xi = n_xi;
  h.n_ct = n_ct;
  h.is_auto = is_auto;
  h.nb = nb;
  h.nb8 = (nb + 7) / 8 * 8;
  args->out = {out_total, out_xi, (size_t)n_nodes * n_xi};
  return batch >= 0 && node_stride >= 0 && params != nullptr &&
         check_half_table(h, &args->q) &&
         make_hod(model, modulate, split, &args->hod);
}

}  // namespace

extern "C" {

// Launch the slab kernel (FP32) on `stream`.  `model`, `modulate` and
// `split` select the occupation (zheng07.cuh): `params` is the (batch,
// n_params) parameter matrix of codes 0 and 1, or code 2's (nb, batch)
// densities.
// `b` holds the n_nodes nodes' column tiles in the layout of
// ops/fused.py:slab_tc_table_constants, node m at b + m * node_stride.
// `stage_steps` is the ring stage in K steps of 8 rows
// (contract.cuh:fp32_stage_ok).  `out_xi` is (batch, n_nodes, n_xi).
// Returns the CUDA error code of the launch (0 on success); the kernel
// runs asynchronously.
int tabcorr_slab(const float* params, int batch, int model, int modulate,
                 double split, const float* logm,
                 const float* res, const float* sec, const float* w, int nb,
                 int nc, int ng, const float* b, long long node_stride,
                 const int* ct_step0, const int* ct_steps, const int* ct_off,
                 const int* col_k, const int* col_i0, int n_ct, int n_nodes,
                 int n_xi, int is_auto, int stage_steps, float* out_total,
                 float* out_xi, int device, void* stream) {
  SlabArgs args;
  if (!make_slab_args(params, batch, model, modulate, split, logm, res,
                      sec, w, nb, nc, ng, b, node_stride, ct_step0, ct_steps,
                      ct_off, col_k, col_i0, n_ct, n_nodes, n_xi, is_auto,
                      out_total, out_xi, &args) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  args.stage_steps = stage_steps;
  constexpr int TB = 64;
  const size_t smem =
      fp32_smem_floats(TB, stage_steps, args.h.nb8, n_xi) * sizeof(float);
  switch (args.hod.model) {
    case kZheng07:
      return launch_slab(slab_kernel<TB, kZheng07>, args, TB, 2 * TB, smem,
                         device, stream);
    case kAssembiasZheng07:
      return launch_slab(slab_kernel<TB, kAssembiasZheng07>, args, TB,
                         2 * TB, smem, device, stream);
    default:
      return launch_slab(slab_kernel<TB, kDensityIn>, args, TB, 2 * TB, smem,
                         device, stream);
  }
}

// Launch the slab_tc kernel (3xTF32 on the tensor cores) on `stream`:
// tabcorr_slab's function from the same constants.  `tb` and `presplit`
// pick the block: 64 rows with the densities split once per block
// (presplit = 1), or 32 rows split at each fragment load.  Returns the
// CUDA error code of the launch.
int tabcorr_slab_tc(const float* params, int batch, int model,
                    int modulate, double split, const float* logm,
                    const float* res, const float* sec, const float* w,
                    int nb, int nc, int ng, const float* b,
                    long long node_stride, const int* ct_step0,
                    const int* ct_steps, const int* ct_off, const int* col_k,
                    const int* col_i0, int n_ct, int n_nodes, int n_xi,
                    int is_auto, int tb, int presplit, float* out_total,
                    float* out_xi, int device, void* stream) {
  SlabArgs args;
  if (!make_slab_args(params, batch, model, modulate, split, logm, res,
                      sec, w, nb, nc, ng, b, node_stride, ct_step0, ct_steps,
                      ct_off, col_k, col_i0, n_ct, n_nodes, n_xi, is_auto,
                      out_total, out_xi, &args))
    return (int)cudaErrorInvalidValue;
  if (tb == 64 && presplit)
    return launch_slab_tc<64, true>(args, device, stream);
  if (tb == 32 && !presplit)
    return launch_slab_tc<32, false>(args, device, stream);
  return (int)cudaErrorInvalidValue;
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
