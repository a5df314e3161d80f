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
//             assembly-bias decoration (zheng07.cuh), once per row;
//   w[b, p]   = n[b, i_p] * n[b, j_p] over the packed pairs i_p <= j_p
//               (np.triu_indices order; auto mode), or n[b, p] (cross);
//   t[b, c]   = sum_p w[b, p] * Fp[p, c], with the columns c node-major
//               (node, k) and the (2 - delta_ij) multiplicity folded into
//               Fp on the host;
//   folded:   xi[b, k] = sum_node nw[b, node] * t[b, (node, k)] / D_b,
//   unfolded: xi[b, node, k] = t[b, (node, k)] / D_b,
//   D_b = (sum_i n[b, i])^2 (auto) or sum_i n[b, i] (cross).
//
// What bounds it on an H100: FP32 FMA in the contraction.  At the 64-node
// 'default' grid (60 bins, 42 rows per node) a parameter vector costs
// 1830 x 2688 multiply-adds against 600 occupation evaluations, with 20
// bytes of parameters and 256 bytes of node weights in and 172 bytes out;
// the 19.7 MB packed matrix stays in the 50 MB L2.  For a cross table with
// many bins (1104 in the 'efficient' Delta Sigma grid) the occupation
// quadrature dominates instead (11,040 evaluations against 1104 x 52
// multiply-adds).
//
// What the design does about it:
// * A block owns TB batch rows (64, or 32 when the densities of 64 rows
//   would not fit in shared memory, as for the 1104-bin table).  Their
//   densities are computed into shared memory once and never touch
//   device memory.
// * The contraction is a register-tiled FP32 GEMM as in bundle.cu: Fp is
//   staged through shared memory in kKT x kCT tiles, each thread
//   accumulates a (TB / 8) x 4 tile.  Each K tile of kKT pairs sums
//   with fmaf into a fresh float32 partial, which is added to a running
//   sum in double.  One sequential float32 sum over 1830 pairs of
//   positive terms put 1.4e-6 (scaled) into the 64-node grid's xi on the
//   card (3.0e-6 at the worst of 1024 rows in a CPU emulation against a
//   float64 contraction); the two-level sum with the double running sum
//   and fold gives 2.3e-7 there, for 32 double adds per 1024 FMAs (and
//   the registers they need: see the launch bounds below).  The
//   pair weights are not
//   materialised (1830 pairs x 64 rows would be 468 KB): each K tile's
//   kKT x TB operand is formed from the staged densities while Fp's tile
//   is staged, one float32 product per element, as tabcorr_tpu forms
//   gi * gj.
// * Each node's columns are padded to nxp (a multiple of 4), so a
//   thread's 4 columns share one node.  The fold's epilogue multiplies
//   them by nw[b, node] and reduces over the nodes of each column tile in
//   node order through shared memory into a TB x nxp accumulator in
//   double (the spline weights have both signs, so the fold cancels up to
//   ~4x): no atomics, bit-reproducible.  The denominator divides once at
//   the end.
// * NaN: nothing skips a zero weight or clamps one, and there is no fast
//   math, so a NaN node weight (a parameter outside the grid) makes every
//   xi of its row NaN.  Rows past the batch end are masked, not padded.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"
#include "zheng07.cuh"

namespace {

using tabcorr::QuadArgs;

constexpr int kThreads = 256;    // 8 row groups x 32 column groups
constexpr int kKT = 32;          // rows (p) of Fp per staged tile
constexpr int kCT = 128;         // columns of Fp per staged tile
constexpr int kRN = 4;           // columns per thread
constexpr int kGroups = kCT / kRN;
constexpr int kRowGroups = kThreads / kGroups;

struct GridArgs {
  const float* params;   // (B, hod.n_params)
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

// Shared-memory layout (floats), per block of TB rows:
//   sN   [nb_rows][TB]  per-bin densities, bin-major
//   sA   [kKT][TB]      the staged K tile of pair weights (auto)
//   sF   [kKT][kCT]     the staged tile of Fp
//   sP   [TB][kCT]      weighted columns of one tile (fold)
//   sQ   [TB][nxp]      folded sums per statistic, double
//   sPar [kParTerms][TB] per-row parameter terms
//   sTot [TB]           sum_i n_i per row
inline size_t smem_floats(int tb, int nb_rows, int nxp) {
  return (size_t)nb_rows * tb + kKT * tb + kKT * kCT + (size_t)tb * kCT +
         2 * (size_t)tb * nxp + (tabcorr::kParTerms + 1) * tb;
}

// Two blocks per SM: the double running sum takes the kernel to 144
// registers, one 256-thread block per SM, and 137.7 ms at the 64-node
// grid (262,144 rows); capped at 128 registers (24 bytes of spill at
// TB = 64) it runs two blocks per SM in 91.6 ms (H100 80GB HBM3, 700 W).
template <int TB, int MODEL>
__global__ void __launch_bounds__(kThreads, 2)
grid_kernel(const GridArgs args) {
  constexpr int kRM = TB / kRowGroups;   // rows per thread
  static_assert(kRM % 4 == 0, "rows per thread are read as float4");
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sA = sN + (size_t)args.nb_rows * TB;
  float* sF = sA + kKT * TB;
  float* sP = sF + kKT * kCT;
  // Every offset above is a multiple of 4 floats, so sQ is 16-byte
  // aligned.
  double* sQ = reinterpret_cast<double*>(sP + TB * kCT);
  float* sPar = reinterpret_cast<float*>(sQ + (size_t)TB * args.nxp);
  float* sTot = sPar + tabcorr::kParTerms * TB;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int rg = tid / kGroups;   // row group: rows rg*kRM .. +kRM-1
  const int cg = tid % kGroups;   // column group: columns cg*kRN .. +kRN-1
  const bool fold = args.nw != nullptr;

  tabcorr::param_terms<TB>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  tabcorr::occupation_phase<TB, kThreads, MODEL>(
      args.q, args.nb_rows, args.batch, row0, args.hod, sPar, sN);
  for (int item = tid; item < TB * args.nxp; item += kThreads)
    sQ[item] = 0.0;
  __syncthreads();
  if (tid < TB) {
    // sum_i n_i in double, as in bundle.cu.
    double sum = 0.0;
    for (int i = 0; i < args.q.nb; ++i) sum += sN[i * TB + tid];
    sTot[tid] = static_cast<float>(sum);
  }

  const float4* sF4 = reinterpret_cast<const float4*>(sF);
  const float4* fp4 = reinterpret_cast<const float4*>(args.fp);
  for (int ct = 0; ct < args.c_pad; ct += kCT) {
    double acc[kRM][kRN];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < kRN; ++c) acc[r][c] = 0.0;

    for (int j0 = 0; j0 < args.k_pad; j0 += kKT) {
      __syncthreads();   // the previous tile's readers are done
      for (int l = tid; l < kKT * kCT / 4; l += kThreads) {
        const int r = l / (kCT / 4);
        const int c4 = l % (kCT / 4);
        reinterpret_cast<float4*>(sF)[l] =
            __ldg(fp4 + ((size_t)(j0 + r) * args.c_pad + ct) / 4 + c4);
      }
      if (args.is_auto) {
        for (int l = tid; l < kKT * TB; l += kThreads) {
          const int p = j0 + l / TB;
          const int b = l % TB;
          float v = 0.f;
          if (p < args.npair)
            v = sN[__ldg(args.pair_i + p) * TB + b] *
                sN[__ldg(args.pair_j + p) * TB + b];
          sA[l] = v;
        }
      }
      __syncthreads();
      // Cross mode: the weights are the densities themselves.
      const float4* sA4 = reinterpret_cast<const float4*>(
          args.is_auto ? sA : sN + (size_t)j0 * TB);
      float part[kRM][kRN];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < kRN; ++c) part[r][c] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kKT; ++jj) {
        float a[kRM];
#pragma unroll
        for (int r4 = 0; r4 < kRM / 4; ++r4) {
          const float4 v = sA4[jj * (TB / 4) + rg * (kRM / 4) + r4];
          a[4 * r4] = v.x;
          a[4 * r4 + 1] = v.y;
          a[4 * r4 + 2] = v.z;
          a[4 * r4 + 3] = v.w;
        }
        const float4 f = sF4[jj * (kCT / 4) + cg];
        const float fv[kRN] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int c = 0; c < kRN; ++c)
            part[r][c] = fmaf(a[r], fv[c], part[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < kRN; ++c) acc[r][c] += (double)part[r][c];
    }

    // Columns ct + cg*4 .. +3 are (node, k0 .. k0+3) of one node.
    const int col = ct + cg * kRN;
    const int node = col / args.nxp;
    const int k0 = col - node * args.nxp;
    if (!fold) {
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int b = rg * kRM + r;
        const size_t row = (size_t)row0 + b;
        if (row < (size_t)args.batch && node < args.n_nodes) {
          const float tot = sTot[b];
          const float den = args.is_auto ? tot * tot : tot;
          float* out = args.out_xi + (row * args.n_nodes + node) * args.n_xi;
#pragma unroll
          for (int c = 0; c < kRN; ++c)
            if (k0 + c < args.n_xi)
              out[k0 + c] = static_cast<float>(acc[r][c]) / den;
        }
      }
      continue;
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const int b = rg * kRM + r;
      float wgt = 0.f;
      if (row0 + b < args.batch && node < args.n_nodes)
        wgt = __ldg(args.nw + (size_t)(row0 + b) * args.n_nodes + node);
#pragma unroll
      for (int c = 0; c < kRN; ++c)
        sP[b * kCT + cg * kRN + c] = static_cast<float>(acc[r][c]) * wgt;
    }
    __syncthreads();
    // One thread per (row, statistic) adds this tile's nodes in order.
    const int node_lo = ct / args.nxp;
    const int node_hi = min((ct + kCT - 1) / args.nxp, args.n_nodes - 1);
    for (int item = tid; item < TB * args.n_xi; item += kThreads) {
      const int b = item / args.n_xi;
      const int k = item % args.n_xi;
      double q = sQ[b * args.nxp + k];
      for (int nd = node_lo; nd <= node_hi; ++nd) {
        const int c = nd * args.nxp + k - ct;
        if (c >= 0 && c < kCT) q += (double)sP[b * kCT + c];
      }
      sQ[b * args.nxp + k] = q;
    }
    // The next tile writes sP only after the __syncthreads() at the top
    // of its j0 loop.
  }
  __syncthreads();

  if (fold) {
    for (int item = tid; item < TB * args.n_xi; item += kThreads) {
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

template <int TB, int MODEL>
int launch(const GridArgs& args, int device, void* stream) {
  const size_t smem = smem_floats(TB, args.nb_rows, args.nxp) *
                      sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grid_kernel<TB, MODEL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (args.batch == 0) return 0;
  const int grid = (args.batch + TB - 1) / TB;
  grid_kernel<TB, MODEL><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// grid_tc: the same function on the tensor cores, in 3xTF32 (the 'scaled'
// tier; tf32x3.cuh).
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

  tabcorr::param_terms<TB>(args.params, args.batch, row0, args.hod, sPar);
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

template <int TB, bool PAIRS_IN_SMEM>
int launch_tc_model(const GridArgs& args, int device, void* stream) {
  using tabcorr::kAssembiasZheng07;
  using tabcorr::kZheng07;
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
  return !bad && tabcorr::make_hod(model, modulate, split, &args.hod);
}

}  // namespace

extern "C" {

// Launch the grid kernel on `stream` with TB = `tb` (32 or 64) rows per
// block.  `model`, `modulate` and `split` select the occupation
// (zheng07.cuh).  `nw` null writes the unfolded (B, n_nodes, n_xi)
// output.  Returns the CUDA error code of the launch (0 on success); the
// kernel runs asynchronously.
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
  using tabcorr::kAssembiasZheng07;
  using tabcorr::kZheng07;
  const bool plain = args.hod.model == kZheng07;
  if (tb == 64)
    return plain ? launch<64, kZheng07>(args, device, stream)
                 : launch<64, kAssembiasZheng07>(args, device, stream);
  if (tb == 32)
    return plain ? launch<32, kZheng07>(args, device, stream)
                 : launch<32, kAssembiasZheng07>(args, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch the grid_tc kernel (3xTF32 on the tensor cores) on `stream`,
// with the arguments of tabcorr_grid; `tb` is 64, 32 or 16 rows per block
// and `pairs_in_smem` keeps the auto pairs' offsets in shared memory (see
// tc_smem_floats).
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
