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
//   full FP32, the 'elementwise' tier (slab_tc below serves 'scaled').

#include <cuda_runtime.h>
#include <math.h>

#include "contract.cuh"
#include "tf32x3.cuh"

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

// ----------------------------------------------------------------------
// slab_tc: the same function on the tensor cores, in 3xTF32 (the 'scaled'
// tier; tf32x3.cuh), over the symmetric half of each node matrix.
//
// The layout (ops/fused.py:slab_tc_table_constants).  Auto mode: the bins
// are cut into tiles of width w; the columns of the GEMM are grouped by
// bin tile I as (I, k, i in I), in n8 column tiles of 8 bins of one
// statistic k (col_k, col_i0).  Column (k, i) takes F[k, i, j] for the
// rows j of i's own tile, 2 F[k, i, j] for the rows of later tiles and 0
// for earlier ones, so that
//     t[b, (k, i)] = sum_j n[b, j] B[j, (k, i)],
//     xi[b, k] = sum_i n[b, i] t[b, (k, i)] / (sum_i n[b, i])^2
// is n^T F n over the block-triangular half: 52.5% of the dense
// multiply-adds at 160 bins with w = 8.  A 128-column tile starts its K
// loop at the first row of its earliest tile (ct_step0, in steps of 8
// rows), and only rows [8 ct_step0, nb8) of it are stored, row-major
// (ct_off); every sum still runs over at most nb terms.  Cross mode keeps
// the matrix-vector layout: column k takes F[k, j], xi = t / sum_i n_i.
//
// What bounds it: the tensor cores' issue rate through mma.sync, and the
// instructions around it (fragment loads, each B fragment's split, the
// epilogue).  The node matrices (147 MB in this layout at the wide grid)
// stream through L2 once per wave of blocks, ~0.2 ms of HBM time.
//
// A block owns TB = 64 batch rows (2 x 8 warps of 32 rows x 16 columns)
// and keeps their float32 densities (the epilogue's n_i) for the whole
// block, bin-major at a row stride of TB + 4 (conflict-free fragment and
// epilogue reads).  At 64 rows the densities are also split into hi/lo
// fragments once per block (2 x 40 KB at 160 bins).  Where those copies do
// not fit in shared memory, the block takes 32 rows (2 x 8 warps of 16
// rows) and splits each A fragment as it is loaded (tc::SplitOnLoadA): one
// copy of 32 rows' densities, so slab_tc takes every shape the slab
// kernel takes (ops/fused.py:slab_tc_config).  The B tiles stream through
// a 2-stage cp.async ring of up to 64 K rows per stage, one block barrier
// per stage, as one sequence over (node, column tile, stage), so the ring
// runs on across tile and node boundaries.  Each chunk (<= 32 K rows, two
// per stage) accumulates into fresh fragments, added to a float32 running
// sum (sums of <= nb terms, as slab_kernel's).  The epilogue reduces n_i
// t[b, (k, i)] over each n8 tile's 8 bins with quad shuffles and adds it
// to the node's statistics in shared memory.  The layout puts a statistic
// at most once in a column tile, or twice in the two n8 tiles of one warp
// (the same lane adds them in order), and the ring's barrier separates the
// column tiles: no two threads add to one statistic between two barriers,
// so the sums are deterministic without the shared-memory round trip and
// the barrier per column tile that an ordered cross-warp reduction needs.
// The column tables (a few ints per tile) are read through the read-only
// cache, not shared memory, whose size would grow with the column count.
struct SlabTcArgs {
  const float* params;   // (B, hod.n_params)
  int batch;
  HodArgs hod;
  QuadArgs q;
  const float* b;        // node m's column tiles at b + m * node_stride
  const int* ct_step0;   // (n_ct,) first K step (8 rows) of column tile ct
  const int* ct_steps;   // (n_ct,) its K steps
  const int* ct_off;     // (n_ct,) float offset of its (steps * 8, 128)
                         // row-major block within a node
  const int* col_k;      // (n_ct * 16,) auto: statistic of each n8 column
                         // tile, -1 for padding
  const int* col_i0;     // (n_ct * 16,) auto: its first bin
  float* out_total;      // (B,)
  float* out_xi;         // (B, n_nodes, n_xi)
  size_t node_stride;
  int n_nodes, n_xi, n_ct, is_auto;
  int nb8;               // bins rounded up to 8: rows of sN
};

constexpr int kTcStages = 2;     // ring stages of kTcStageSteps k-steps
constexpr int kTcStageSteps = 8; // 64 K rows: two accumulation chunks
constexpr int kTcStageFloats = kTcStageSteps * 8 * tc::kBS;
constexpr int kTcN8 = tc::kCT / 8;   // n8 column tiles per column tile

// Shared-memory layout (floats), per block of TB rows:
//   sN   [nb8][TB + 4]         float32 densities, bin-major
//   sAh, sAl [nb8 * TB]        (PRESPLIT) their hi/lo, fragment order
//   sB   [2][64][kBS]          the cp.async ring of B tiles
//   sXi  [TB][n_xi]            one node's statistics (auto)
//   sPar [kParTerms][TB], sTot [TB]
template <int TB, bool PRESPLIT>
struct SlabTc {
  static constexpr int kStride = TB + 4;
  static constexpr int kWM = 2, kWN = tc::kWarps / kWM;   // warps
  static constexpr int kMT = TB / 32;                   // m16 tiles
  static constexpr int kNT = tc::kCT / (8 * kWN);       // n8 tiles
  static size_t smem_floats(int nb8, int n_xi) {
    return (size_t)nb8 * kStride + (PRESPLIT ? 2 * (size_t)nb8 * TB : 0) +
           kTcStages * kTcStageFloats + (size_t)TB * n_xi +
           (kParTerms + 1) * TB;
  }
};

// Position of a block's stream over (node, column tile, stage), given the
// column tiles' K steps.
struct SlabCursor {
  int node, ct, q;
  __device__ void advance(const int* steps, int n_ct) {
    if (kTcStageSteps * ++q >= __ldg(steps + ct)) {
      q = 0;
      if (++ct == n_ct) {
        ct = 0;
        ++node;
      }
    }
  }
};

template <int TB, bool PRESPLIT, int MODEL>
__global__ void __launch_bounds__(tc::kThreads, 1)
slab_tc_kernel(const SlabTcArgs args) {
  using S = SlabTc<TB, PRESPLIT>;
  constexpr int NST = kTcStages, MT = S::kMT, NT = S::kNT, SN = S::kStride;
  constexpr int kM16 = TB / 16;
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sAh = sN + (size_t)args.nb8 * SN;
  float* sAl = sAh + (PRESPLIT ? (size_t)args.nb8 * TB : 0);
  float* sB = sAl + (PRESPLIT ? (size_t)args.nb8 * TB : 0);
  float* sXi = sB + NST * kTcStageFloats;
  float* sPar = sXi + (size_t)TB * args.n_xi;
  float* sTot = sPar + kParTerms * TB;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int n0 = wn * NT * 8;      // the warp's first column in the tile
  const int m0 = wm * MT;          // and its first m16 tile
  const int row0 = blockIdx.x * TB;

  param_terms<TB>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  occupation_phase<TB, tc::kThreads, MODEL, SN>(args.q, args.nb8, args.batch,
                                                row0, args.hod, sPar, sN);
  for (int item = tid; item < TB * args.n_xi; item += tc::kThreads)
    sXi[item] = 0.f;
  __syncthreads();
  if (tid < TB) {
    double sum = 0.0;   // in double, as contract.cuh
    for (int i = 0; i < args.q.nb; ++i) sum += sN[i * SN + tid];
    sTot[tid] = static_cast<float>(sum);
  }
  if constexpr (PRESPLIT) {
    // The densities' hi/lo in fragment order (slot l holds row `row`, bin
    // kk): consecutive threads store consecutive words.
    for (int l = tid; l < args.nb8 * TB; l += tc::kThreads) {
      const int e = l & 3, ln = (l >> 2) & 31, ms = l >> 7;
      const int row = (ms % kM16) * 16 + (ln >> 2) + 8 * (e & 1);
      const int kk = (ms / kM16) * 8 + (ln & 3) + 4 * (e >> 1);
      uint32_t hi, lo;
      tc::split_tf32(sN[kk * SN + row], hi, lo);
      sAh[l] = __uint_as_float(hi);
      sAl[l] = __uint_as_float(lo);
    }
  }

  int stages_per_node = 0;
  for (int c = 0; c < args.n_ct; ++c)
    stages_per_node +=
        (__ldg(args.ct_steps + c) + kTcStageSteps - 1) / kTcStageSteps;
  const int n_stages = args.n_nodes * stages_per_node;
  SlabCursor prod = {0, 0, 0}, cons = {0, 0, 0};
  int issued = 0;
  auto issue = [&]() {
    if (issued < n_stages) {
      const int n_rows =
          8 * min(kTcStageSteps,
                  __ldg(args.ct_steps + prod.ct) - kTcStageSteps * prod.q);
      tc::stage_b(sB + (issued % NST) * kTcStageFloats,
                  args.b + (size_t)prod.node * args.node_stride +
                      __ldg(args.ct_off + prod.ct) +
                      (size_t)prod.q * kTcStageSteps * 8 * tc::kCT,
                  tc::kCT, n_rows);
      prod.advance(args.ct_steps, args.n_ct);
    }
    ++issued;
    tc::cp_async_commit();
  };
  for (int s = 0; s < NST - 1; ++s) issue();

  float run[MT][NT][4];
  float acc[MT][NT][4], acc_lo[MT][NT][4];
  for (int s = 0; s < n_stages; ++s) {
    const int ct = cons.ct;
    const int steps = __ldg(args.ct_steps + ct);
    const int step0 = __ldg(args.ct_step0 + ct);
    tc::cp_async_wait<NST - 2>();
    __syncthreads();   // stage s is in; slot s - 1 is free
    issue();
    const int n_steps = min(kTcStageSteps, steps - kTcStageSteps * cons.q);
    if (cons.q == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.f;
    }
    // The stage's K rows in chunks of at most kKT, each into fresh
    // accumulators.
    for (int c0 = 0; c0 < n_steps; c0 += tc::kKT / 8) {
      const int s0 = step0 + kTcStageSteps * cons.q + c0;
      const float* stage = sB + (s % NST) * kTcStageFloats + c0 * 8 * tc::kBS;
      const int n_chunk = min(tc::kKT / 8, n_steps - c0);
      if constexpr (PRESPLIT)
        tc::chunk_mma<MT, NT, true>(
            acc, acc_lo,
            tc::FragOrderA{reinterpret_cast<const float4*>(sAh),
                           reinterpret_cast<const float4*>(sAl), kM16, s0,
                           m0},
            stage, n0, n_chunk);
      else
        tc::chunk_mma<MT, NT, true>(acc, acc_lo,
                                    tc::SplitOnLoadA<SN>{sN, s0, m0}, stage,
                                    n0, n_chunk);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            run[mi][ni][e] += acc[mi][ni][e] + acc_lo[mi][ni][e];
    }
    const int node = cons.node;
    const bool tile_done = kTcStageSteps * (cons.q + 1) >= steps;
    const bool node_done = tile_done && ct == args.n_ct - 1;
    cons.advance(args.ct_steps, args.n_ct);
    if (!tile_done) continue;

    // Epilogue of column tile ct: fragment element e of (mi, ni) is row
    // (m0 + mi)*16 + g + 8*(e / 2), column n0 + ni*8 + 2t + e % 2.
    if (!args.is_auto) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = (m0 + mi) * 16 + g + 8 * (e >> 1);
            const int k = ct * tc::kCT + n0 + ni * 8 + 2 * t + (e & 1);
            if (row0 + b < args.batch && k < args.n_xi)
              args.out_xi[((size_t)(row0 + b) * args.n_nodes + node) *
                              args.n_xi + k] = run[mi][ni][e] / sTot[b];
          }
      continue;
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int c = ct * kTcN8 + wn * NT + ni;
      const int k = __ldg(args.col_k + c);
      const int i = __ldg(args.col_i0 + c) + 2 * t;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = (m0 + mi) * 16 + g + 8 * h;
          float v = sN[i * SN + b] * run[mi][ni][2 * h];
          v = fmaf(sN[(i + 1) * SN + b], run[mi][ni][2 * h + 1], v);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && k >= 0) sXi[b * args.n_xi + k] += v;
        }
    }
    if (!node_done) continue;
    __syncthreads();   // the node's statistics are complete
    for (int item = tid; item < TB * args.n_xi; item += tc::kThreads) {
      const int b = item / args.n_xi;
      const int k = item - b * args.n_xi;
      if (row0 + b < args.batch) {
        const float tot = sTot[b];
        args.out_xi[((size_t)(row0 + b) * args.n_nodes + node) * args.n_xi +
                    k] = sXi[item] / (tot * tot);
      }
      sXi[item] = 0.f;
    }
    // The next node adds to sXi only after the __syncthreads() of its
    // first stage.
  }
  if (tid < TB && row0 + tid < args.batch)
    args.out_total[row0 + tid] = sTot[tid];
}

template <int TB, bool PRESPLIT, int MODEL>
int launch_slab_tc(const SlabTcArgs& args, int device, void* stream) {
  const size_t smem =
      SlabTc<TB, PRESPLIT>::smem_floats(args.nb8, args.n_xi) * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(slab_tc_kernel<TB, PRESPLIT, MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  const int grid = (args.batch + TB - 1) / TB;
  slab_tc_kernel<TB, PRESPLIT, MODEL><<<grid, tc::kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}

template <int TB, bool PRESPLIT>
int launch_slab_tc_model(const SlabTcArgs& args, int device, void* stream) {
  return args.hod.model == kZheng07
             ? launch_slab_tc<TB, PRESPLIT, kZheng07>(args, device, stream)
             : launch_slab_tc<TB, PRESPLIT, kAssembiasZheng07>(args, device,
                                                                stream);
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

// Launch the slab_tc kernel (3xTF32 on the tensor cores) on `stream`.
// `b` holds the n_nodes nodes' column tiles in the layout of
// ops/fused.py:slab_tc_table_constants, node m at b + m * node_stride.
// `tb` and `presplit` pick the block: 64 rows with the densities split
// once per block (presplit = 1), or 32 rows split at each fragment load.
// `out_xi` is (batch, n_nodes, n_xi).  Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously.
int tabcorr_slab_tc(const float* params, int batch, int model, int modulate,
                    double split, const float* logm, const float* res,
                    const float* sec, const float* w, int nb, int nc, int ng,
                    const float* b, long long node_stride, const int* ct_step0,
                    const int* ct_steps, const int* ct_off, const int* col_k,
                    const int* col_i0, int n_ct, int n_nodes, int n_xi,
                    int is_auto, int tb, int presplit, float* out_total,
                    float* out_xi, int device, void* stream) {
  SlabTcArgs args = {};
  args.params = params;
  args.batch = batch;
  args.q.logm = logm;
  args.q.res = res;
  args.q.sec = sec;
  args.q.w = w;
  args.q.nb = nb;
  args.q.nc = nc;
  args.q.ng = ng;
  args.b = b;
  args.ct_step0 = ct_step0;
  args.ct_steps = ct_steps;
  args.ct_off = ct_off;
  args.col_k = col_k;
  args.col_i0 = col_i0;
  args.out_total = out_total;
  args.out_xi = out_xi;
  args.node_stride = (size_t)node_stride;
  args.n_nodes = n_nodes;
  args.n_xi = n_xi;
  args.n_ct = n_ct;
  args.is_auto = is_auto;
  args.nb8 = (nb + 7) / 8 * 8;
  if (batch < 0 || nb < 1 || nc < 0 || nc > nb || ng < 1 || n_nodes < 1 ||
      n_xi < 1 || n_ct < 1 || node_stride < 0 ||
      !make_hod(model, modulate, split, &args.hod))
    return (int)cudaErrorInvalidValue;
  if (tb == 64 && presplit)
    return launch_slab_tc_model<64, true>(args, device, stream);
  if (tb == 32 && !presplit)
    return launch_slab_tc_model<32, false>(args, device, stream);
  return (int)cudaErrorInvalidValue;
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
