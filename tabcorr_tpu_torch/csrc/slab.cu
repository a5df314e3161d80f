// Slab grid kernel (B4) for Hopper (sm_90a): every node of a stacked
// Interpolator grid of one halo binning, per node and without the spline,
// for a batch of parameter vectors.
//
// Replaces: tabcorr_tpu/ops/fused.py:make_fused_grid_predictor with
// layout='slab' (the node-streamed slab kernel; tabcorr_tpu's route for
// auto grids whose packed pair row exceeds 8192 lanes, i.e. more than 127
// bins).  It computes what that kernel computes, not its block structure:
//
//   n[b, i]            zheng07 occupation quadrature, optionally with the
//                      Heaviside assembly-bias decoration (zheng07.cuh),
//                      once per row;
//   xi[b, node, k]   = n_b^T F_node,k n_b / (sum_i n_bi)^2   (auto)
//                    = (F_node n_b)_k / sum_i n_bi           (cross)
//
// The grid spline runs afterwards in tensor ops (predictor.py), as
// tabcorr_tpu's XLA spline follows its slab kernel.
//
// What bounds it on an H100: FP32 FMA.  At the 64-node wide grid (160
// bins, 42 rows per node) a parameter vector costs 64 x 42 x 160^2 =
// 6.9e7 multiply-adds against 1,600 occupation evaluations, with 28 bytes
// of parameters in and 10,756 bytes out.  The 275 MB of node matrices do
// not fit in the 50 MB L2, but the blocks in flight walk the nodes in the
// same order at about the same pace, so each node's 4.3 MB is read from
// device memory about once per wave of blocks.
//
// What the design does about it:
// * A block owns 64 batch rows.  Their densities are computed into shared
//   memory once (40 KB at 160 bins) and reused by every node.
// * Each node is B1's contraction (contract.cuh): a register-tiled FP32
//   GEMM t = n F_t over the node's slab, then the quadratic form's
//   epilogue; sums run over nb = 160 terms, short enough for float32
//   (tabcorr_tpu's packed form would sum 12,880 pair terms per column).
// * Each node's 64 x 42 statistics go straight to device memory: the
//   block's whole output (64 x 2688 floats) would not fit in shared
//   memory.  No bf16 pass groups, no 128-lane packing, no row permutation:
//   full FP32 for both accuracy contracts.

#include <cuda_runtime.h>
#include <math.h>

#include "contract.cuh"

namespace {

using namespace tabcorr;

struct SlabArgs {
  const float* params;   // (B, hod.n_params)
  int batch;
  HodArgs hod;
  int n_nodes;
  TableArgs t;           // node 0; node m's slab is t.ft + m * k_pad * c_pad
                         // and its output t.out_xi + m * n_xi
};

template <int MODEL>
__global__ void __launch_bounds__(kThreads, kMinBlocksSlab)
slab_kernel(const SlabArgs args) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), args.t.k_pad,
                       args.t.n_xi);
  const int row0 = blockIdx.x * kTB;

  param_terms<kTB>(args.params, args.batch, row0, args.hod, s.sPar);
  __syncthreads();
  occupation_phase<kTB, kThreads, MODEL>(args.t.q, args.t.k_pad, args.batch,
                                         row0, args.hod, s.sPar, s.sN);
  __syncthreads();

  const size_t slab = (size_t)args.t.k_pad * args.t.c_pad;
  for (int node = 0; node < args.n_nodes; ++node) {
    TableArgs t = args.t;
    t.ft += node * slab;
    t.out_xi += (size_t)node * t.n_xi;
    if (node > 0) t.out_total = nullptr;
    contract_table(t, args.batch, row0, s);
  }
}

template <int MODEL>
int launch_slab(const SlabArgs& args, int device, void* stream) {
  const size_t smem = smem_floats(args.t.k_pad, args.t.n_xi) * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(slab_kernel<MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (args.batch == 0) return 0;
  const int grid = (args.batch + kTB - 1) / kTB;
  slab_kernel<MODEL><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the slab kernel on `stream`.  `model`, `modulate` and `split`
// select the occupation (zheng07.cuh); `ft` holds the n_nodes slabs
// (k_pad, c_pad) one after another in the bundle layout; `out_xi` is
// (batch, n_nodes, n_xi).  Returns the CUDA error code of the launch (0 on
// success); the kernel runs asynchronously.
int tabcorr_slab(const float* params, int batch, int model, int modulate,
                 double split, const float* logm, const float* res,
                 const float* sec, const float* w, int nb, int nc, int ng,
                 const float* ft, int n_nodes, int n_xi, int nbp, int k_pad,
                 int c_pad, int is_auto, float* out_total, float* out_xi,
                 int device, void* stream) {
  SlabArgs args = {};
  args.params = params;
  args.batch = batch;
  args.n_nodes = n_nodes;
  TableArgs& t = args.t;
  t.q.logm = logm;
  t.q.res = res;
  t.q.sec = sec;
  t.q.w = w;
  t.q.nb = t.nb = nb;
  t.q.nc = nc;
  t.q.ng = ng;
  t.ft = ft;
  t.out_total = out_total;
  t.out_xi = out_xi;
  t.n_xi = n_xi;
  t.nbp = nbp;
  t.k_pad = k_pad;
  t.c_pad = c_pad;
  t.is_auto = is_auto;
  t.out_stride = n_nodes * n_xi;
  if (batch < 0 || n_nodes < 1 || nc < 0 || nc > nb || ng < 1 ||
      !check_table(t) || !make_hod(model, modulate, split, &args.hod))
    return (int)cudaErrorInvalidValue;
  return args.hod.model == kZheng07
             ? launch_slab<kZheng07>(args, device, stream)
             : launch_slab<kAssembiasZheng07>(args, device, stream);
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
