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
//             computed beforehand (occupation.cu or tensor ops);
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
              "grid_kernel stages Fp in tf32x3.cuh's tiles");

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

// The launch arguments of tabcorr_grid, or false for shapes the kernel
// does not take.
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

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
