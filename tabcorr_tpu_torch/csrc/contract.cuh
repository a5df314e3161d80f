// The contraction shared by the bundle and contraction kernels (bundle.cu)
// and the slab kernels (slab.cu):
//
//     auto:  xi[b, node, k] = n_b^T F_node,k n_b / (sum_i n_bi)^2
//     cross: xi[b, node, k] = (F_node n_b)_k / sum_i n_bi
//
// for the TB batch rows of one block, from their densities n[b, i] in
// shared memory, for every node of one table (a bundle table is one node):
// contract_fp32() on the CUDA cores, which the contraction and FP32 slab
// kernels run under every contract and the bundle kernel for its
// 'elementwise' and cross tables.  (The 'scaled' slab kernel, slab_tc in
// slab.cu, and the bundle kernel's 'scaled' auto tables read the same
// columns split into TF32 halves, ops/fused.py:slab_split_table_constants.)
//
// The layout (ops/fused.py:slab_tc_table_constants).  Auto mode, the
// block-triangular half: the bins are cut into tiles of width w; the
// columns of the GEMM are grouped by bin tile I as (I, k, i in I), in n8
// column tiles of 8 bins of one statistic k (col_k, col_i0).  Column
// (k, i) takes F[k, i, j] for the rows j of i's own tile, 2 F[k, i, j]
// (exact in float32) for the rows of later tiles and 0 for earlier ones,
// so that
//     t[b, (k, i)] = sum_j n[b, j] B[j, (k, i)],
//     xi[b, k] = sum_i n[b, i] t[b, (k, i)] / (sum_i n[b, i])^2
// is n^T F n over the symmetric half: 52.5% of the dense multiply-adds at
// 160 bins with w = 8.  A 128-column tile starts its K loop at the first
// row of its earliest bin tile (ct_step0, in steps of 8 rows), and only
// rows [8 ct_step0, nb8) of it are stored, row-major (ct_off); every sum
// still runs over at most nb terms.  Cross mode keeps the matrix-vector
// layout: column k takes F[k, j], xi = t / sum_i n_i.
//
// It streams the column tiles through a 2-stage cp.async ring, one block
// barrier per stage, as one sequence over (node, column tile, stage), so
// the ring runs on across tile and node boundaries.  It reduces
// n_i t[b, (k, i)] over each n8 tile's 8 bins in registers and adds it to
// the node's statistics in shared memory once per column tile, from a sum
// it carries in 8 registers and feeds after every ring stage, so that no
// fmaf chain runs over more than the stage's 32 K rows
// (tests/test_torch_contract_half.py emulates this order and one chain over
// all of a column's rows, which lands farther from the float64 contraction
// of xi_ell).  The layout puts a statistic at most
// once in a column tile, or twice in one aligned pair of n8 tiles (handled
// by one lane, or by two neighbouring lanes that combine their sums with a
// shuffle), and the ring's barrier separates the column tiles: no two
// threads add to one statistic between two barriers, so the sums are
// deterministic without the shared-memory round trip and the barrier per
// column tile that an ordered cross-warp reduction needs.  sum_i n_i is
// accumulated in double.  Rows past the batch end are masked, not padded.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32x3.cuh"
#include "zheng07.cuh"

namespace tabcorr {

constexpr int kCT = 128;          // columns per column tile
constexpr int kSlots = kCT / 8;   // n8 column tiles per column tile
constexpr int kStages = 2;        // ring stages
// contract_fp32: a thread owns 8 rows x the 8 columns of one n8 tile; a
// block of TB rows has TB / 8 row groups x 16 column groups = 2 TB threads.
constexpr int kRM = 8;
// Its ring stage in K steps of 8 rows: 4 (32 K rows), or 2 where that ring
// does not fit in shared memory beside the densities.
constexpr int kFpStageSteps = 4;
constexpr int kFpStageStepsSmall = 2;
inline bool fp32_stage_ok(int stage_steps) {
  return stage_steps == kFpStageSteps || stage_steps == kFpStageStepsSmall;
}
// Minimum resident blocks per SM in the FP32 kernels' __launch_bounds__.
// Without a minimum, ptxas aims at a register count of its own and spills
// or not depending on small edits elsewhere.  Three 64-row blocks is what
// the bench tables' shared memory allows (~75 KB each); the wide slab
// grid's 160 bins allow two.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksSlab = 2;

// The constants of one table in the layout above.
struct HalfTable {
  const float* b;        // node m's column tiles at b + m * node_stride
  const int* ct_step0;   // (n_ct,) first K step (8 rows) of column tile ct
  const int* ct_steps;   // (n_ct,) its K steps
  const int* ct_off;     // (n_ct,) float offset of its (steps * 8, 128)
                         // row-major block within a node
  const int* col_k;      // (n_ct * 16,) auto: statistic of each n8 column
                         // tile, -1 for padding
  const int* col_i0;     // (n_ct * 16,) auto: its first bin
  size_t node_stride;
  int n_nodes, n_xi, n_ct, is_auto;
  int nb;                // bins
  int nb8;               // bins rounded up to 8: rows of sN
};

// Where a table's results go: row b's sum_i n_i at total[b] (null: not
// stored), node m's statistic k at xi[b * stride + m * n_xi + k].
struct TableOut {
  float* total;
  float* xi;
  size_t stride;
};

inline bool check_half_table(const HalfTable& h, const QuadArgs* q) {
  if (h.nb < 1 || h.n_nodes < 1 || h.n_xi < 1 || h.n_ct < 1) return false;
  return q == nullptr ||
         (q->nb == h.nb && q->nc >= 0 && q->nc <= h.nb && q->ng >= 1);
}

// Position of a block's stream over (node, column tile, stage), given the
// column tiles' K steps and the K steps per stage.
struct TileCursor {
  int node, ct, q;
  __device__ __forceinline__ void advance(const int* steps, int n_ct,
                                          int stage_steps) {
    if (stage_steps * ++q >= __ldg(steps + ct)) {
      q = 0;
      if (++ct == n_ct) {
        ct = 0;
        ++node;
      }
    }
  }
};

// Ring stages of one node: sum over the column tiles of their stages.
__device__ __forceinline__ int stages_per_node(const HalfTable& h,
                                               int stage_steps) {
  int n = 0;
  for (int c = 0; c < h.n_ct; ++c)
    n += (__ldg(h.ct_steps + c) + stage_steps - 1) / stage_steps;
  return n;
}

// sTot[b] = sum_i n[b, i] for the block's TB rows, by the threads tid <
// TB of the contraction.  In double: a float32 running sum over ~100 bins
// would carry ~5e-7 relative error into xi's 1/(sum n)^2.
template <int TB, int STRIDE>
__device__ __forceinline__ void row_totals(const float* sN, int nb,
                                           float* sTot, unsigned tid) {
  if (tid < TB) {
    double sum = 0.0;
    for (int i = 0; i < nb; ++i) sum += sN[i * STRIDE + tid];
    sTot[tid] = static_cast<float>(sum);
  }
}

// A barrier over the NT threads that run contract_fp32: the block's (BAR
// 0), or named barrier BAR where they are warpgroup BAR - 1 of a larger
// block (the bundle kernel's consumer warpgroups, bundle.cu).
template <int NT, int BAR>
__device__ __forceinline__ void contract_sync() {
  if constexpr (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"n"(BAR), "n"(NT) : "memory");
}

// ----------------------------------------------------------------------
// The FP32 contraction.
//
// What bounds it: FP32 FMA issue.  What the design does about it: each of
// the 2 TB threads owns an 8 x 8 register tile (8 rows x one n8 column
// tile), so a K row costs 64 fmaf against four 16-byte shared-memory loads
// (two of densities, two of the staged matrix row), each one wavefront: a
// warp is 4 row groups x 8 column groups, the densities of 4 row groups
// are 4 x 32 consecutive bytes, and a staged row keeps the first halves of
// its 16 n8 tiles in floats [0, 64) and the second halves in [64, 128), so
// that the 8 column groups of a warp read 128 consecutive bytes.  That is
// a quarter of the shared-memory traffic per fmaf of an 8 x 4 tile whose
// 32 lanes read 32 different matrix words.  The matrix rows arrive through
// the cp.async ring while the previous stage is multiplied (one barrier
// per stage of up to 32 K rows), and only the symmetric half of an auto
// table is multiplied.  Folding a stage into the carried sums is 64 fmaf
// and 16 shared-memory loads against the stage's 2048 and 128; a stage's
// first K row stores its products instead of adding them to zeros, which
// saves the 64 moves that would clear the tile.
//
// Start copying rows [0, n_rows) of a column tile (row-major, 128 floats
// per row) into a ring stage, the halves of each n8 tile apart.  Threads
// tid in [0, NT) call it; the caller commits the group.
template <int NT>
__device__ __forceinline__ void stage_fp32(float* dst, const float* src,
                                           int n_rows, int tid) {
  for (int l = tid; l < n_rows * (kCT / 4); l += NT) {
    const int r = l / (kCT / 4);
    const int q = l % (kCT / 4);      // 16-byte chunk of the row
    cp_async16(dst + r * kCT + ((q & 1) * kSlots + (q >> 1)) * 4,
               src + r * kCT + q * 4);
  }
}

// acc (+)= A[rows, 8 K rows] x B[8 K rows, the thread's 8 columns] from
// shared memory (a4: the densities of the thread's rows at the first K
// row, b4: the staged rows at the thread's n8 tile).  FIRST: the sums
// start here, so the first row's products are stored, not added to zeros.
template <int STRIDE, bool FIRST>
__device__ __forceinline__ void fp32_k_step(float (&acc)[kRM][8],
                                            const float4* a4,
                                            const float4* b4) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float4 a0 = a4[jj * (STRIDE / 4)];
    const float4 a1 = a4[jj * (STRIDE / 4) + 1];
    const float4 b0 = b4[jj * (kCT / 4)];
    const float4 b1 = b4[jj * (kCT / 4) + kSlots];
    const float a[kRM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[r][c] = FIRST && jj == 0 ? __fmul_rn(a[r], bv[c])
                                     : fmaf(a[r], bv[c], acc[r][c]);
  }
}

// xi and sum_i n_i of every node of one table for the block's TB rows, by
// 2 TB threads: the block (BAR 0), or warpgroup BAR - 1 of a larger block,
// synchronised by the named barrier BAR (contract_sync).  On entry sN holds
// n[b, i] at sN[i * STRIDE + b] for i < nb8 (0 for padded bins and masked
// rows) and a barrier has passed since it was written; on exit the outputs
// are stored and the threads are synchronised, so sN, sXi and sTot may be
// overwritten.  `stage_steps` (fp32_stage_ok) is the K steps of 8 rows per
// ring stage; sRing holds kStages * stage_steps * 8 * 128 floats, sXi TB *
// n_xi, sTot TB.
template <int TB, int BAR = 0, int STRIDE = TB>
__device__ __forceinline__ void contract_fp32(const HalfTable& h,
                                              const TableOut& out, int batch,
                                              int row0, int stage_steps,
                                              const float* sN, float* sRing,
                                              float* sXi, float* sTot) {
  static_assert(TB % 32 == 0 && STRIDE % 4 == 0 && STRIDE >= TB &&
                    (BAR == 0 || 2 * TB == 128), "block shape");
  constexpr int NT = 2 * TB;
  constexpr unsigned kTid0 = BAR == 0 ? 0 : NT * (BAR - 1);
  const int tid = threadIdx.x - kTid0;
  const int warp = tid >> 5, lane = tid & 31;
  const int rg = (warp >> 1) * 4 + (lane >> 3);   // rows rg * 8 .. + 7
  const int cg = (warp & 1) * 8 + (lane & 7);     // n8 tile of the column tile
  const int stage_floats = stage_steps * 8 * kCT;

  for (int item = tid; item < TB * h.n_xi; item += NT) sXi[item] = 0.f;
  row_totals<TB, STRIDE>(sN, h.nb, sTot, threadIdx.x - kTid0);

  const int n_stages = h.n_nodes * stages_per_node(h, stage_steps);
  TileCursor prod = {0, 0, 0}, cons = {0, 0, 0};
  int issued = 0;
  auto issue = [&]() {
    if (issued < n_stages) {
      const int n_rows =
          8 * min(stage_steps,
                  __ldg(h.ct_steps + prod.ct) - stage_steps * prod.q);
      stage_fp32<NT>(sRing + (issued % kStages) * stage_floats,
                     h.b + (size_t)prod.node * h.node_stride +
                         __ldg(h.ct_off + prod.ct) +
                         (size_t)prod.q * stage_steps * 8 * kCT,
                     n_rows, tid);
      prod.advance(h.ct_steps, h.n_ct, stage_steps);
    }
    ++issued;
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue();

  float acc[kRM][8];
  float v[kRM];   // auto: sum_i n_i t[b, (k, i)] of the column tile so far
  for (int s = 0; s < n_stages; ++s) {
    const int ct = cons.ct;
    const int steps = __ldg(h.ct_steps + ct);
    const int step0 = __ldg(h.ct_step0 + ct);
    cp_async_wait<kStages - 2>();
    contract_sync<NT, BAR>();   // stage s is in; slot s - 1 is free
    issue();
    const int n_rows = 8 * min(stage_steps, steps - stage_steps * cons.q);
    const float4* a4 =
        reinterpret_cast<const float4*>(
            sN + (size_t)8 * (step0 + stage_steps * cons.q) * STRIDE) +
        rg * 2;
    const float4* b4 =
        reinterpret_cast<const float4*>(sRing +
                                        (s % kStages) * stage_floats) + cg;
    // Auto mode folds every stage's products into v (below), so its sums
    // start anew with each stage; cross mode sums over the column tile.
    if (h.is_auto || cons.q == 0)
      fp32_k_step<STRIDE, true>(acc, a4, b4);
    else
      fp32_k_step<STRIDE, false>(acc, a4, b4);
#pragma unroll 1
    for (int j0 = 8; j0 < n_rows; j0 += 8)
      fp32_k_step<STRIDE, false>(acc, a4 + j0 * (STRIDE / 4),
                                 b4 + j0 * (kCT / 4));
    const int node = cons.node;
    const bool first = cons.q == 0;
    const bool tile_done = stage_steps * (cons.q + 1) >= steps;
    const bool node_done = tile_done && ct == h.n_ct - 1;
    cons.advance(h.ct_steps, h.n_ct, stage_steps);

    // Epilogue: acc[r][c] is row rg * 8 + r, column ct * 128 + cg * 8 + c,
    // summed over the column tile's K rows (cross) or this stage's (auto).
    if (!h.is_auto) {
      if (!tile_done) continue;
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int b = rg * kRM + r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int k = ct * kCT + cg * 8 + c;
          if (row0 + b < batch && k < h.n_xi)
            out.xi[(size_t)(row0 + b) * out.stride + (size_t)node * h.n_xi +
                   k] = acc[r][c] / sTot[b];
        }
      }
      continue;
    }
    const int i0 = __ldg(h.col_i0 + ct * kSlots + cg);
    if (first) {
#pragma unroll
      for (int r = 0; r < kRM; ++r) v[r] = 0.f;
    }
    const float4* n4 =
        reinterpret_cast<const float4*>(sN + (size_t)i0 * STRIDE) + rg * 2;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 n0 = n4[c * (STRIDE / 4)];
      const float4 n1 = n4[c * (STRIDE / 4) + 1];
      const float nv[kRM] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
#pragma unroll
      for (int r = 0; r < kRM; ++r) v[r] = fmaf(nv[r], acc[r][c], v[r]);
    }
    if (!tile_done) continue;
    // Two n8 tiles of one aligned pair may hold the same statistic: the
    // even lane adds both sums, its neighbour none.
    const int k = __ldg(h.col_k + ct * kSlots + cg);
    const int k_pair = __shfl_xor_sync(0xffffffffu, k, 1);
    const bool paired = k >= 0 && k == k_pair;
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const float other = __shfl_xor_sync(0xffffffffu, v[r], 1);
      if (k >= 0 && !(paired && (cg & 1)))
        sXi[(rg * kRM + r) * h.n_xi + k] += paired ? v[r] + other : v[r];
    }
    if (!node_done) continue;
    contract_sync<NT, BAR>();   // the node's statistics are complete
    for (int item = tid; item < TB * h.n_xi; item += NT) {
      const int b = item / h.n_xi;
      const int kk = item - b * h.n_xi;
      if (row0 + b < batch) {
        const float tot = sTot[b];
        out.xi[(size_t)(row0 + b) * out.stride + (size_t)node * h.n_xi + kk] =
            sXi[item] / (tot * tot);
      }
      sXi[item] = 0.f;
    }
    // The next node adds to sXi only after the barrier of its first stage.
  }
  if (out.total != nullptr && tid < TB && row0 + tid < batch)
    out.total[row0 + tid] = sTot[tid];
  contract_sync<NT, BAR>();   // before the caller reuses sN, sXi and sTot
}

// Shared-memory floats of contract_fp32's ring, statistics, per-row
// parameter terms and row totals, beside the densities.
inline size_t fp32_smem_floats(int tb, int stage_steps, int nb8, int n_xi) {
  return (size_t)nb8 * tb + (size_t)kStages * stage_steps * 8 * kCT +
         (size_t)tb * n_xi + (kParTerms + 1) * tb;
}

}  // namespace tabcorr
