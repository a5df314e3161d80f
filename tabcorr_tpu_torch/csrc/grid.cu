// Grid kernel (B2) for Hopper (sm_90a): the whole Interpolator grid of
// one halo binning for a batch of parameter vectors, with the grid spline
// folded in.
//
// Replaces: tabcorr_tpu/ops/fused.py:_make_grid_packed_predictor (the
// Pallas packed-layout grid kernel, reached through
// make_fused_grid_predictor).  It computes what that kernel computes, not
// its block structure:
//
//   n[b, i]   zheng07 occupation quadrature, optionally with the Heaviside
//             assembly-bias decoration (zheng07.cuh), once per row, or
//             for any other model (code 2) read from the densities
//             computed beforehand (occupation.cu or tensor ops;
//             grid_kernel only);
//   w[b, p]   = n[b, i_p] * n[b, j_p] over the packed pairs i_p <= j_p
//               (np.triu_indices order; auto mode), or n[b, p] (cross);
//   t[b, c]   = sum_p w[b, p] * Fp[p, c], with the columns c node-major
//               (node, k) and the (2 - delta_ij) multiplicity folded into
//               Fp on the host;
//   folded:   xi[b, k] = sum_node nw[b, node] * t[b, (node, k)] / D_b,
//   unfolded: xi[b, node, k] = t[b, (node, k)] / D_b,
//   D_b = (sum_i n[b, i])^2 (auto) or sum_i n[b, i] (cross).
//
// grid_kernel (both accuracy contracts) runs the contraction on the FP64
// tensor cores.  What bounds it on an H100: the FP64 tensor-core rate
// (67 TFLOP/s, as the FP32 CUDA cores): at the 64-node 'default' grid (60
// bins, 42 rows per node) a parameter vector costs 1830 x 2688
// multiply-adds against 600 occupation evaluations, with 20 bytes of
// parameters and 256 bytes of node weights in and 172 bytes out; the
// 20.9 MB packed matrix stays in the 50 MB L2.  For a cross table with many
// bins (1104 in the 'efficient' Delta Sigma grid) the occupation
// quadrature dominates instead (11,040 evaluations against 1104 x 52
// multiply-adds).
//
// What the design does about it:
// * A block owns TB batch rows (64; 32 or 16 where the densities of more
//   rows would not fit in shared memory, as for the 1104-bin table).
//   Their densities are computed into shared memory once and never touch
//   device memory.
// * The contraction is a stream of stages (column tile ct of kCT = 128
//   columns, K chunk q of kKT = 32 pairs) on mma.sync m16n8k8 f64: each
//   MMA warp owns 32 rows (16 in a 16-row block) x 32 columns of the tile,
//   one float64 accumulator per output over all K: no partial sums, no
//   running sum, and no chain restarted (float64 rounding over 1856 terms
//   stays far below the float32 operands' own).
// * Fp stays float32 in device memory and streams through a cp.async ring
//   (cp_async.cuh) of 32 x 128 stages; each element is widened to float64
//   (exactly) when its B fragment is loaded, by each warp that reads it
//   (two at 64 rows): a float64 copy of a stage would take another 32 KB
//   of shared memory.  The pair weights, one float32 product n_i n_j per
//   element (as tabcorr_tpu forms g_i g_j), are widened and stored in
//   fragment order (double-buffered, conflict-free 16-byte loads), formed
//   while the previous chunk's MMAs run: at 64 rows each warp forms its
//   share between its own k-steps.  Cross mode widens the densities
//   themselves.
// * A 64-row block has 8 warps (2 x 4 over the tile), two blocks per SM.
//   Where the 1104-bin table's densities fill shared memory (32- and
//   16-row blocks), the block has 16 warps: all of them evaluate the
//   occupation, stage and form the weights, and the first four run the
//   MMAs.
// * The fold's epilogue multiplies each column's float64 sum by the node
//   weight nw[b, node] in float64 and adds it to a TB x nxp float64
//   accumulator in shared memory, node by node with a barrier between
//   nodes, so each output is summed in node order (the spline weights
//   have both signs, so the fold cancels up to ~4x): no atomics,
//   bit-reproducible.  The denominator divides once at the end.
// * NaN: nothing skips a zero weight or clamps one, and there is no fast
//   math, so a NaN node weight (a parameter outside the grid) makes every
//   xi of its row NaN.  Rows past the batch end are masked, not padded.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"
#include "zheng07.cuh"

namespace {

using tabcorr::QuadArgs;

constexpr int kKT = 32;          // rows (p) of Fp per staged chunk
constexpr int kCT = 128;         // columns of Fp per staged tile
constexpr int kRN = 4;           // node columns are padded to a multiple
constexpr int kMmaK = 8;         // K of one mma.sync m16n8k8 f64
constexpr int kBS = tabcorr::tc::kBS;   // staged row stride (floats)
static_assert(kKT == tabcorr::tc::kKT && kCT == tabcorr::tc::kCT,
              "both kernels stage Fp in tf32x3.cuh's tiles");

struct GridArgs {
  const float* params;   // (B, hod.n_params); code 2: unread (q.dens)
  const float* nw;       // (B, n_nodes) node weights; null: no fold
  QuadArgs q;
  const int* pair_i;     // (npair,) auto: the pairs' first bins
  const int* pair_j;     // (npair,) auto: the pairs' second bins
  const float* fp;       // (k_pad, c_pad) packed matrix, column
                         // node * nxp + k
  float* out_total;      // (B,)
  float* out_xi;         // (B, n_xi) folded, (B, n_nodes, n_xi) unfolded
  tabcorr::HodArgs hod;
  int batch, is_auto, npair, k_pad, c_pad, n_nodes, n_xi, nxp;
  int nb_rows;           // bins rounded up to kKT (rows of sN)
};

// The block shape of TB rows.  The MMA warps form a kWM x 4 grid over
// the TB x 128 tile, each warp (TB / kWM) rows x 32 columns.  At 64 rows:
// 8 warps, all of them MMA warps, two ring stages, two blocks per SM.  At
// 32 and 16 rows, where a block's densities fill shared memory and one
// block holds the SM: 16 warps for the occupation, the first 4 of them MMA
// warps, and three stages (no other block's copies to overlap).
template <int TB>
struct F64Grid {
  static constexpr int kWM = TB == 64 ? 2 : 1;
  static constexpr int kMmaWarps = 4 * kWM;
  static constexpr int kThreads = TB == 64 ? 256 : 512;
  static constexpr int kMinBlocks = TB == 64 ? 2 : 1;
  static constexpr int kStages = TB == 64 ? 2 : 3;
  static constexpr int kMT = TB / kWM / 16;     // m16 tiles per warp
};

// Shared-memory layout (bytes), per block of TB rows:
//   sA   double [2][kKT * TB]   the chunk's pair weights in fragment order,
//                               double-buffered
//   sQ   double [TB][nxp]       folded sums per statistic
//   sB   float  [stages][kKT][kBS]  the cp.async ring of Fp tiles
//   sN   float  [nb_rows][TB]   per-bin densities, bin-major
//   sPar float  [kParTerms][TB] per-row parameter terms
//   sTot float  [TB]            sum_i n_i per row
template <int TB>
size_t smem_bytes(int nb_rows, int nxp) {
  return 8 * (2 * (size_t)kKT * TB + (size_t)TB * nxp) +
         4 * ((size_t)F64Grid<TB>::kStages * kKT * kBS + (size_t)nb_rows * TB +
              (tabcorr::kParTerms + 1) * (size_t)TB);
}

// d += a b on one m16n8k8 f64 tile: lane (g = lane / 4, t = lane % 4)
// holds a_i = A[g + 8 (i % 2)][t + 4 (i / 2)], b_i = B[t + 4 i][g] and
// d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <int TB, bool AUTO, int MODEL>
__global__ void __launch_bounds__(F64Grid<TB>::kThreads,
                                  F64Grid<TB>::kMinBlocks)
grid_kernel(const GridArgs args) {
  using S = F64Grid<TB>;
  constexpr int NT = S::kThreads, MT = S::kMT, kStages = S::kStages;
  constexpr int kM16 = TB / 16;
  constexpr int kNT8 = 32 / 8;               // n8 tiles per warp
  constexpr int kHalves = kMmaK / 4;         // double2 per lane per A tile
  constexpr int kSteps = kKT / kMmaK;        // k-steps per chunk
  constexpr int kItems = kKT * TB / 2;       // double2 of a chunk's weights
  // At 64 rows every warp runs the MMAs, and forms its share of the next
  // chunk's weights between its k-steps, where ptxas can interleave the
  // two; otherwise the other warps form them after the MMAs are issued.
  constexpr bool kAllMma = NT == S::kMmaWarps * 32;
  static_assert(!kAllMma || kItems % (NT * kSteps) == 0,
                "each k-step forms whole items per thread");
  extern __shared__ double4 smem_d4[];
  double* sA = reinterpret_cast<double*>(smem_d4);
  double* sQ = sA + 2 * kKT * TB;
  float* sB = reinterpret_cast<float*>(sQ + (size_t)TB * args.nxp);
  float* sN = sB + kStages * kKT * kBS;
  float* sPar = sN + (size_t)args.nb_rows * TB;
  float* sTot = sPar + tabcorr::kParTerms * TB;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool mma_warp = kAllMma || warp < S::kMmaWarps;
  const int n0 = (warp & 3) * 32;            // the warp's first column
  const int m0 = (warp >> 2) * MT;           // and its first m16 tile
  const int row0 = blockIdx.x * TB;
  const bool fold = args.nw != nullptr;

  tabcorr::param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod,
                                  sPar);
  __syncthreads();
  tabcorr::occupation_phase<TB, NT, MODEL>(
      args.q, args.nb_rows, args.batch, row0, args.hod, sPar, sN);
  for (int item = tid; item < TB * args.nxp; item += NT) sQ[item] = 0.0;
  __syncthreads();
  if (tid < TB) {
    // sum_i n_i in double, as in bundle.cu.
    double sum = 0.0;
    for (int i = 0; i < args.q.nb; ++i) sum += sN[i * TB + tid];
    sTot[tid] = static_cast<float>(sum);
  }

  // Stage s is (column tile s / nq, chunk s % nq); the ring's copies keep
  // their position as counters.
  const int nq = args.k_pad / kKT;
  const int n_stages = nq * (args.c_pad / kCT);
  int p_ct = 0, p_q = 0;
  auto issue = [&](int s) {
    if (s < n_stages) {
      tabcorr::tc::stage_b<NT>(sB + (s % kStages) * kKT * kBS,
                               args.fp + (size_t)p_q * kKT * args.c_pad +
                                   (size_t)p_ct * kCT,
                               args.c_pad, kKT);
      if (++p_q == nq) {
        p_q = 0;
        ++p_ct;
      }
    }
    tabcorr::cp_async_commit();
  };
  // Item f of chunk q's weights (kKT pairs x TB rows) in fragment order:
  // double2 (k-step ks, m16 tile m, half h, lane) holds A[r][p] and
  // A[r + 8][p], r = 16 m + lane / 4, p = kMmaK ks + lane % 4 + 4 h, so a
  // warp's load of one half is 512 contiguous bytes.  Each weight is one
  // float32 product, widened exactly; pairs past npair give weight 0.
  auto form_item = [&](double2* a2, int q, int f) {
    const int ln = f & 31, rest = f >> 5;
    const int h = rest % kHalves, ms = rest / kHalves;
    const int r = (ms % kM16) * 16 + (ln >> 2);
    const int p = q * kKT + (ms / kM16) * kMmaK + (ln & 3) + 4 * h;
    float v0, v1;
    if constexpr (AUTO) {
      const int pc = min(p, args.npair - 1);
      const float* ni = sN + __ldg(args.pair_i + pc) * TB + r;
      const float* nj = sN + __ldg(args.pair_j + pc) * TB + r;
      const bool real = p < args.npair;
      v0 = real ? ni[0] * nj[0] : 0.f;
      v1 = real ? ni[8] * nj[8] : 0.f;
    } else {
      v0 = sN[p * TB + r];          // p < k_pad == nb_rows; 0 past nb
      v1 = sN[p * TB + r + 8];
    }
    a2[f] = make_double2(static_cast<double>(v0), static_cast<double>(v1));
  };
  auto a_buf = [&](int buf) {
    return reinterpret_cast<double2*>(sA + buf * kKT * TB);
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int f = tid; f < kItems; f += NT) form_item(a_buf(0), 0, f);

  // Column tile ct, then its chunks q; s counts the stages.  The
  // accumulators are cleared once per tile, ahead of the chunk loop, never
  // by a clear selected inside it (on q == 0): ptxas (CUDA 12.8) folds
  // that into the first MMA's predicated-accumulator form, and the rows
  // g + 8 of the accumulators then came out wrong from the second chunk
  // on (64-row blocks).
  const int n_ct = args.c_pad / kCT;
  int s = 0;
  for (int ct = 0; ct < n_ct; ++ct) {
    double acc[MT][kNT8][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
    for (int q = 0; q < nq; ++q, ++s) {
      const int q_next = q + 1 == nq ? 0 : q + 1;
      tabcorr::cp_async_wait<kStages - 2>();
      __syncthreads();   // stage s and its weights are in; slot s - 1 is free
      issue(s + kStages - 1);
      // The next chunk's weights (past the last stage a harmless copy of
      // chunk 0) go to the buffer chunk s - 1 read, before the barrier.
      double2* next = a_buf((s + 1) & 1);
      if (mma_warp) {
        const double2* a2 = a_buf(s & 1);
        const float* sb = sB + (s % kStages) * kKT * kBS;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          double a[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
            for (int h = 0; h < kHalves; ++h) {
              const double2 v =
                  a2[((ks * kM16 + m0 + mi) * kHalves + h) * 32 + lane];
              a[mi][2 * h] = v.x;
              a[mi][2 * h + 1] = v.y;
            }
          }
          const float* b_row = sb + (ks * kMmaK + t) * kBS + n0 + g;
#pragma unroll
          for (int ni = 0; ni < kNT8; ++ni) {
            const double b[2] = {static_cast<double>(b_row[ni * 8]),
                                 static_cast<double>(b_row[4 * kBS + ni * 8])};
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) mma_f64(acc[mi][ni], a[mi], b);
          }
          if constexpr (kAllMma) {
            constexpr int kPer = kItems / (NT * kSteps);
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              form_item(next, q_next, tid + NT * (ks * kPer + j));
          }
        }
      }
      if constexpr (!kAllMma)
        for (int f = tid; f < kItems; f += NT) form_item(next, q_next, f);
    }

    // Epilogue of column tile ct: accumulator element e of (mi, ni) is
    // row 16 (m0 + mi) + g + 8 (e / 2), column n0 + 8 ni + 2 t + e % 2.
    if (!fold) {
      if (mma_warp) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNT8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int b = (m0 + mi) * 16 + g + 8 * (e >> 1);
              const int col = ct * kCT + n0 + ni * 8 + 2 * t + (e & 1);
              const int node = col / args.nxp;
              const int k = col - node * args.nxp;
              const size_t row = (size_t)row0 + b;
              if (row < (size_t)args.batch && node < args.n_nodes &&
                  k < args.n_xi) {
                const float tot = sTot[b];
                const float den = args.is_auto ? tot * tot : tot;
                args.out_xi[(row * args.n_nodes + node) * args.n_xi + k] =
                    static_cast<float>(acc[mi][ni][e]) / den;
              }
            }
      }
      continue;
    }
    // Fold: the tile's nodes in order, one barrier after each, so that
    // every sQ element takes its nodes in node order.
    const int col0 = ct * kCT;
    const int node_lo = col0 / args.nxp;
    const int node_hi = min((col0 + kCT - 1) / args.nxp, args.n_nodes - 1);
    int cnode[kNT8][2], ck[kNT8][2];
#pragma unroll
    for (int ni = 0; ni < kNT8; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + n0 + ni * 8 + 2 * t + c;
        cnode[ni][c] = col / args.nxp;
        ck[ni][c] = col - cnode[ni][c] * args.nxp;
      }
    for (int nd = node_lo; nd <= node_hi; ++nd) {
      if (mma_warp) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int b = (m0 + mi) * 16 + g + 8 * r;
            if (row0 + b >= args.batch) continue;
            const double wgt = static_cast<double>(
                __ldg(args.nw + (size_t)(row0 + b) * args.n_nodes + nd));
#pragma unroll
            for (int ni = 0; ni < kNT8; ++ni)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (cnode[ni][c] == nd && ck[ni][c] < args.n_xi)
                  sQ[b * args.nxp + ck[ni][c]] +=
                      wgt * acc[mi][ni][2 * r + c];
          }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  if (fold) {
    for (int item = tid; item < TB * args.n_xi; item += NT) {
      const int b = item / args.n_xi;
      const int k = item % args.n_xi;
      if (row0 + b < args.batch) {
        const float tot = sTot[b];
        const float den = args.is_auto ? tot * tot : tot;
        args.out_xi[(size_t)(row0 + b) * args.n_xi + k] =
            static_cast<float>(sQ[b * args.nxp + k]) / den;
      }
    }
  }
  if (tid < TB && row0 + tid < args.batch)
    args.out_total[row0 + tid] = sTot[tid];
}

template <int TB, bool AUTO, int MODEL>
int launch(const GridArgs& args, int device, void* stream) {
  namespace tc = tabcorr::tc;
  const size_t smem = smem_bytes<TB>(args.nb_rows, args.nxp);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(grid_kernel<TB, AUTO, MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  const int grid = (args.batch + TB - 1) / TB;
  grid_kernel<TB, AUTO, MODEL><<<grid, F64Grid<TB>::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

template <int TB, bool AUTO>
int launch_model(const GridArgs& args, int device, void* stream) {
  using namespace tabcorr;
  switch (args.hod.model) {
    case kZheng07:
      return launch<TB, AUTO, kZheng07>(args, device, stream);
    case kAssembiasZheng07:
      return launch<TB, AUTO, kAssembiasZheng07>(args, device, stream);
    default:
      return launch<TB, AUTO, kDensityIn>(args, device, stream);
  }
}

template <int TB>
int launch_mode(const GridArgs& args, int device, void* stream) {
  return args.is_auto ? launch_model<TB, true>(args, device, stream)
                      : launch_model<TB, false>(args, device, stream);
}

// ----------------------------------------------------------------------
// grid_tc: the same function on the tensor cores, in 3xTF32 (tf32x3.cuh);
// slower than grid_kernel, so no contract routes to it
// (ops/fused.py:grid_kernel_for).
//
// What bounds it: the tensor cores' issue rate through mma.sync (grid64:
// 3 x 2 x 1856 x 2816 TF32 FLOP per row), then the split of each B
// fragment and the A tile's formation.  The design:
// * The same occupation into shared memory as grid_kernel, then the
//   contraction as a stream of stages (column tile ct, K chunk q): Fp's
//   32 x 128 tile is staged by a cp.async ring (3 stages at 64 rows, 2 at
//   32 or 16), and the chunk's pair weights w = n_i n_j (auto) or n_p
//   (cross), the same float32 products as grid_kernel, are formed and
//   split into hi/lo under the previous chunk's MMAs (double-buffered),
//   one lane-fragment (16-byte store) per thread (free of bank conflicts;
//   a store per weight would conflict 8-way).  The pairs' offsets into the
//   densities sit in shared memory where they fit, else they are read
//   through the read-only cache.
// * A block owns 64 rows, or 32 or 16 where fewer rows' densities, the
//   split pair weights and the ring fit in shared memory (the 1104-bin
//   table takes 32): it takes every shape grid_kernel takes
//   (ops/fused.py:grid_tc_config).  16 warps in a kWM x kWN grid, each
//   kMT m16 tiles x kNT n8 tiles of the 128-column tile.
// * Each chunk (32 pairs) accumulates into a fresh fragment, added to a
//   running sum in double (grid_kernel's two-level sum: one float32 sum
//   over the 1830 pairs cost 1.4e-6 scaled).  The fold and its NaN
//   semantics are grid_kernel's, line for line.
template <int TB>
struct TcGrid {
  static constexpr int kMT = TB == 16 ? 1 : 2;       // m16 tiles per warp
  static constexpr int kWM = TB / (16 * kMT);        // warps along the rows
  static constexpr int kWN = tabcorr::tc::kWarps / kWM;   // and columns
  static constexpr int kNT = tabcorr::tc::kCT / (8 * kWN);   // n8 tiles
  static constexpr int kStages = TB == 64 ? 3 : 2;
};

// Shared-memory layout (floats), per block of TB rows:
//   sN   [nb_rows][TB]        per-bin densities, bin-major
//   sAh, sAl [2][kKT * TB]    the chunk's pair weights, hi and lo, in
//                             fragment order (tc::FragOrderA), double-
//                             buffered
//   sB   [stages][kKT][kBS]   the cp.async ring of Fp tiles
//   sP   [TB][kCT]            weighted columns of one tile (fold)
//   sQ   [TB][nxp]            folded sums per statistic, double
//   sPar [kParTerms][TB], sTot [TB]
//   sPi, sPj [k_pad]          (auto, pairs_in_smem) each pair's bins times
//                             TB: offsets into sN
template <int TB>
size_t tc_smem_floats(int nb_rows, int nxp, int k_pad, bool pairs_in_smem) {
  using namespace tabcorr;
  return (size_t)nb_rows * TB + 4 * (size_t)tc::kKT * TB +
         (size_t)TcGrid<TB>::kStages * tc::kStageFloats +
         (size_t)TB * tc::kCT + 2 * (size_t)TB * nxp + (kParTerms + 1) * TB +
         (pairs_in_smem ? 2 * (size_t)k_pad : 0);
}

template <int TB, bool PAIRS_IN_SMEM, int MODEL>
__global__ void __launch_bounds__(tabcorr::tc::kThreads, 1)
grid_tc_kernel(const GridArgs args) {
  namespace tc = tabcorr::tc;
  using S = TcGrid<TB>;
  constexpr int MT = S::kMT, NT = S::kNT, NST = S::kStages;
  constexpr int kM16 = TB / 16;
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sAh = sN + (size_t)args.nb_rows * TB;
  float* sAl = sAh + 2 * tc::kKT * TB;
  float* sB = sAl + 2 * tc::kKT * TB;
  float* sP = sB + NST * tc::kStageFloats;
  double* sQ = reinterpret_cast<double*>(sP + TB * tc::kCT);
  float* sPar = reinterpret_cast<float*>(sQ + (size_t)TB * args.nxp);
  float* sTot = sPar + tabcorr::kParTerms * TB;
  int* sPi = reinterpret_cast<int*>(sTot + TB);
  int* sPj = sPi + args.k_pad;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int n0 = wn * NT * 8;      // the warp's first column in the tile
  const int m0 = wm * MT;          // and its first m16 tile
  const int row0 = blockIdx.x * TB;
  const bool fold = args.nw != nullptr;

  tabcorr::param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod,
                                  sPar);
  __syncthreads();
  tabcorr::occupation_phase<TB, tc::kThreads, MODEL>(
      args.q, args.nb_rows, args.batch, row0, args.hod, sPar, sN);
  for (int item = tid; item < TB * args.nxp; item += tc::kThreads)
    sQ[item] = 0.0;
  __syncthreads();
  if (tid < TB) {
    double sum = 0.0;
    for (int i = 0; i < args.q.nb; ++i) sum += sN[i * TB + tid];
    sTot[tid] = static_cast<float>(sum);
  }
  if (PAIRS_IN_SMEM) {
    for (int p = tid; p < args.k_pad; p += tc::kThreads) {
      const bool real = p < args.npair;
      sPi[p] = real ? __ldg(args.pair_i + p) * TB : 0;
      sPj[p] = real ? __ldg(args.pair_j + p) * TB : 0;
    }
  }
  __syncthreads();   // the first chunk's weights read sPi and sPj

  // Stage s is (column tile s / nq, chunk s % nq); the producer (the
  // ring's copies) and the consumer keep their positions as counters.
  const int nq = args.k_pad / tc::kKT;
  const int n_stages = nq * (args.c_pad / tc::kCT);
  int p_ct = 0, p_q = 0;
  auto issue = [&](int s) {
    if (s < n_stages) {
      tc::stage_b(sB + (s % NST) * tc::kStageFloats,
                  args.fp + (size_t)p_q * tc::kKT * args.c_pad +
                      (size_t)p_ct * tc::kCT,
                  args.c_pad, tc::kKT);
      if (++p_q == nq) {
        p_q = 0;
        ++p_ct;
      }
    }
    tc::cp_async_commit();
  };
  // Chunk q's weights (stage s), kKT pairs x TB rows, into buffer s & 1 in
  // fragment
  // order (tc::FragOrderA): a thread forms one lane's float4 of one m16 x
  // k8 tile, rows g and g + 8, pairs t and t + 4, and stores it in one
  // 16-byte word (conflict-free).  Pairs past npair give weight 0.
  auto offsets = [&](int p, int& oi, int& oj) {
    if constexpr (PAIRS_IN_SMEM) {
      oi = sPi[p];
      oj = sPj[p];
    } else {
      oi = __ldg(args.pair_i + p) * TB;
      oj = __ldg(args.pair_j + p) * TB;
    }
  };
  auto form = [&](int s, int q) {
    float4* ah = reinterpret_cast<float4*>(sAh + (s & 1) * tc::kKT * TB);
    float4* al = reinterpret_cast<float4*>(sAl + (s & 1) * tc::kKT * TB);
    for (int f = tid; f < tc::kKT * TB / 4; f += tc::kThreads) {
      const int ln = f & 31, ms = f >> 5;
      const int r0 = (ms % kM16) * 16 + (ln >> 2);
      const int p0 = q * tc::kKT + (ms / kM16) * 8 + (ln & 3);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e & 1), p = p0 + 4 * (e >> 1);
        if (!args.is_auto) {
          v[e] = sN[p * TB + row];   // p < k_pad == nb_rows; 0 past nb
        } else if (p < args.npair) {
          int oi, oj;
          offsets(p, oi, oj);
          v[e] = sN[oi + row] * sN[oj + row];
        } else {
          v[e] = 0.f;
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split_tf32(v[e], hi[e], lo[e]);
      ah[f] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                          __uint_as_float(hi[2]), __uint_as_float(hi[3]));
      al[f] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                          __uint_as_float(lo[2]), __uint_as_float(lo[3]));
    }
  };
  for (int s = 0; s < NST - 1; ++s) issue(s);
  form(0, 0);

  double run[MT][NT][4];
  float acc[MT][NT][4];
  int c_ct = 0, c_q = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int ct = c_ct, q = c_q;
    if (++c_q == nq) {
      c_q = 0;
      ++c_ct;
    }
    tc::cp_async_wait<NST - 2>();
    __syncthreads();   // stage s and its weights are in; slot s - 1 is free
    issue(s + NST - 1);
    if (q == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.0;
    }
    const int buf = (s & 1) * tc::kKT * TB;
    const tc::FragOrderA load_a{reinterpret_cast<const float4*>(sAh + buf),
                                reinterpret_cast<const float4*>(sAl + buf),
                                kM16, 0, m0};
    tc::chunk_mma<MT, NT, false>(acc, acc, load_a,
                                 sB + (s % NST) * tc::kStageFloats, n0,
                                 tc::kKT / 8);
    // The next chunk's weights while the MMAs are in flight: its buffer
    // was last read by chunk s - 1, before this stage's barrier.
    if (s + 1 < n_stages) form(s + 1, c_q);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[mi][ni][e] += (double)acc[mi][ni][e];
    if (q != nq - 1) continue;

    // Epilogue of column tile ct: fragment element e of (mi, ni) is row
    // (m0 + mi)*16 + g + 8*(e / 2), column n0 + ni*8 + 2t + e % 2.
    if (!fold) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = (m0 + mi) * 16 + g + 8 * (e >> 1);
            const int col = ct * tc::kCT + n0 + ni * 8 + 2 * t + (e & 1);
            const int node = col / args.nxp;
            const int k = col - node * args.nxp;
            const size_t row = (size_t)row0 + b;
            if (row < (size_t)args.batch && node < args.n_nodes &&
                k < args.n_xi) {
              const float tot = sTot[b];
              const float den = args.is_auto ? tot * tot : tot;
              args.out_xi[(row * args.n_nodes + node) * args.n_xi + k] =
                  static_cast<float>(run[mi][ni][e]) / den;
            }
          }
      continue;
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = (m0 + mi) * 16 + g + 8 * (e >> 1);
          const int c = n0 + ni * 8 + 2 * t + (e & 1);
          const int node = (ct * tc::kCT + c) / args.nxp;
          float wgt = 0.f;
          if (row0 + b < args.batch && node < args.n_nodes)
            wgt = __ldg(args.nw + (size_t)(row0 + b) * args.n_nodes + node);
          sP[b * tc::kCT + c] = static_cast<float>(run[mi][ni][e]) * wgt;
        }
    __syncthreads();
    // One thread per (row, statistic) adds this tile's nodes in order.
    const int ct0 = ct * tc::kCT;
    const int node_lo = ct0 / args.nxp;
    const int node_hi = min((ct0 + tc::kCT - 1) / args.nxp, args.n_nodes - 1);
    for (int item = tid; item < TB * args.n_xi; item += tc::kThreads) {
      const int b = item / args.n_xi;
      const int k = item % args.n_xi;
      double acc_q = sQ[b * args.nxp + k];
      for (int nd = node_lo; nd <= node_hi; ++nd) {
        const int c = nd * args.nxp + k - ct0;
        if (c >= 0 && c < tc::kCT) acc_q += (double)sP[b * tc::kCT + c];
      }
      sQ[b * args.nxp + k] = acc_q;
    }
    // The next tile writes sP only after the __syncthreads() of its
    // first stage.
  }
  __syncthreads();

  if (fold) {
    for (int item = tid; item < TB * args.n_xi; item += tc::kThreads) {
      const int b = item / args.n_xi;
      const int k = item % args.n_xi;
      if (row0 + b < args.batch) {
        const float tot = sTot[b];
        const float den = args.is_auto ? tot * tot : tot;
        args.out_xi[(size_t)(row0 + b) * args.n_xi + k] =
            static_cast<float>(sQ[b * args.nxp + k]) / den;
      }
    }
  }
  if (tid < TB && row0 + tid < args.batch)
    args.out_total[row0 + tid] = sTot[tid];
}

template <int TB, bool PAIRS_IN_SMEM, int MODEL>
int launch_tc(const GridArgs& args, int device, void* stream) {
  namespace tc = tabcorr::tc;
  const size_t smem =
      tc_smem_floats<TB>(args.nb_rows, args.nxp, args.k_pad, PAIRS_IN_SMEM) *
      sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(grid_tc_kernel<TB, PAIRS_IN_SMEM, MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  const int grid = (args.batch + TB - 1) / TB;
  grid_tc_kernel<TB, PAIRS_IN_SMEM, MODEL>
      <<<grid, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// grid_tc is on no path and takes models 0 and 1 only (no code 2).
template <int TB, bool PAIRS_IN_SMEM>
int launch_tc_model(const GridArgs& args, int device, void* stream) {
  using tabcorr::kAssembiasZheng07;
  using tabcorr::kZheng07;
  if (args.hod.model == tabcorr::kDensityIn)
    return (int)cudaErrorInvalidValue;
  return args.hod.model == kZheng07
             ? launch_tc<TB, PAIRS_IN_SMEM, kZheng07>(args, device, stream)
             : launch_tc<TB, PAIRS_IN_SMEM, kAssembiasZheng07>(args, device,
                                                               stream);
}

template <int TB>
int launch_tc_pairs(const GridArgs& args, bool pairs_in_smem, int device,
                    void* stream) {
  return pairs_in_smem ? launch_tc_model<TB, true>(args, device, stream)
                       : launch_tc_model<TB, false>(args, device, stream);
}

// The launch arguments of tabcorr_grid / tabcorr_grid_tc, or false for
// shapes the kernels do not take.
bool make_grid_args(const float* params, const float* nw, int batch,
                    int model, int modulate, double split, const float* logm,
                    const float* res, const float* sec, const float* w,
                    int nb, int nc, int ng, const int* pair_i,
                    const int* pair_j, int npair, const float* fp, int k_pad,
                    int c_pad, int n_nodes, int n_xi, int nxp, int is_auto,
                    float* out_total, float* out_xi, GridArgs* a) {
  GridArgs& args = *a;
  args = GridArgs{};
  args.params = params;
  args.nw = nw;
  args.q.logm = logm;
  args.q.res = res;
  args.q.sec = sec;
  args.q.w = w;
  args.q.dens = model == tabcorr::kDensityIn ? params : nullptr;
  args.q.nb = nb;
  args.q.nc = nc;
  args.q.ng = ng;
  args.pair_i = pair_i;
  args.pair_j = pair_j;
  args.fp = fp;
  args.out_total = out_total;
  args.out_xi = out_xi;
  args.batch = batch;
  args.is_auto = is_auto;
  args.npair = npair;
  args.k_pad = k_pad;
  args.c_pad = c_pad;
  args.n_nodes = n_nodes;
  args.n_xi = n_xi;
  args.nxp = nxp;
  args.nb_rows = (nb + kKT - 1) / kKT * kKT;
  const bool bad =
      batch < 0 || nb < 1 || nc < 0 || nc > nb || ng < 1 || n_nodes < 1 ||
      n_xi < 1 || nxp < n_xi || nxp % kRN || k_pad % kKT || c_pad % kCT ||
      c_pad < n_nodes * nxp || k_pad < npair ||
      (is_auto ? npair != nb * (nb + 1) / 2 : npair != nb) ||
      (!is_auto && k_pad != args.nb_rows);
  return !bad && params != nullptr &&
         tabcorr::make_hod(model, modulate, split, &args.hod);
}

}  // namespace

extern "C" {

// Launch the grid kernel (FP64 tensor cores) on `stream` with TB = `tb`
// (64, 32 or 16) rows per block (see smem_bytes).  `model`, `modulate` and
// `split` select the occupation (zheng07.cuh): `params` is the (batch,
// n_params) parameter matrix of codes 0 and 1, or code 2's (nb, batch)
// densities.  `nw` null writes the unfolded (B, n_nodes, n_xi) output.
// Returns the CUDA error code of the launch (0 on success); the kernel
// runs asynchronously.
int tabcorr_grid(const float* params, const float* nw, int batch, int model,
                 int modulate, double split, const float* logm,
                 const float* res, const float* sec, const float* w, int nb,
                 int nc, int ng, const int* pair_i,
                 const int* pair_j, int npair, const float* fp, int k_pad,
                 int c_pad, int n_nodes, int n_xi, int nxp, int is_auto,
                 int tb, float* out_total, float* out_xi, int device,
                 void* stream) {
  GridArgs args;
  if (!make_grid_args(params, nw, batch, model, modulate, split, logm, res,
                      sec, w, nb, nc, ng, pair_i, pair_j, npair, fp, k_pad,
                      c_pad, n_nodes, n_xi, nxp, is_auto, out_total, out_xi,
                      &args))
    return (int)cudaErrorInvalidValue;
  if (tb == 64) return launch_mode<64>(args, device, stream);
  if (tb == 32) return launch_mode<32>(args, device, stream);
  if (tb == 16) return launch_mode<16>(args, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch the grid_tc kernel (3xTF32 on the tensor cores) on `stream`,
// with the arguments of tabcorr_grid (model codes 0 and 1 only); `tb` is
// 64, 32 or 16 rows per block and `pairs_in_smem` keeps the auto pairs'
// offsets in shared memory (see tc_smem_floats).
int tabcorr_grid_tc(const float* params, const float* nw, int batch,
                    int model, int modulate, double split, const float* logm,
                    const float* res, const float* sec, const float* w,
                    int nb, int nc, int ng, const int* pair_i,
                    const int* pair_j, int npair, const float* fp, int k_pad,
                    int c_pad, int n_nodes, int n_xi, int nxp, int is_auto,
                    int tb, int pairs_in_smem, float* out_total,
                    float* out_xi, int device, void* stream) {
  GridArgs args;
  if (!make_grid_args(params, nw, batch, model, modulate, split, logm, res,
                      sec, w, nb, nc, ng, pair_i, pair_j, npair, fp, k_pad,
                      c_pad, n_nodes, n_xi, nxp, is_auto, out_total, out_xi,
                      &args))
    return (int)cudaErrorInvalidValue;
  // Cross mode has no pairs to keep.
  const bool in_smem = is_auto && pairs_in_smem;
  if (tb == 64) return launch_tc_pairs<64>(args, in_smem, device, stream);
  if (tb == 32) return launch_tc_pairs<32>(args, in_smem, device, stream);
  if (tb == 16) return launch_tc_pairs<16>(args, in_smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
