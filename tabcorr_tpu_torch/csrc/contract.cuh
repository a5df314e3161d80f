// The per-table contraction shared by the bundle and contraction kernels
// (bundle.cu) and the slab kernel (slab.cu):
//
//     auto:  xi[b, k] = n_b^T F_k n_b / (sum_i n_bi)^2
//     cross: xi[b, k] = (F n_b)_k / sum_i n_bi
//
// for the kTB batch rows of one block, from their densities n[b, i] in
// shared memory.
//
// * t[b, (k, i)] = sum_j n[b, j] F[k, i, j] is a register-tiled FP32 GEMM:
//   F is staged through shared memory in kKT x kCT tiles, each thread
//   accumulates an 8 x 4 tile (8 rows x 4 consecutive columns) with fmaf,
//   so every staged F element is reused by 64 rows and every n value by
//   128 columns.
// * The quadratic form's epilogue multiplies each thread's columns by
//   n[b, i] and reduces them per statistic k through shared memory in a
//   fixed order (deterministic), then divides by (sum_i n_i)^2 (auto) or
//   sum_i n_i (cross); that sum is accumulated in double.  Rows past the
//   batch end are masked, not padded.

#pragma once

#include <cuda_runtime.h>

#include "zheng07.cuh"

namespace tabcorr {

constexpr int kTB = 64;          // batch rows per block
constexpr int kThreads = 256;    // 8 row groups x 32 column groups
constexpr int kKT = 32;          // rows (j) of F per staged tile
constexpr int kCT = 128;         // columns of F per staged tile
constexpr int kRM = 8;           // rows per thread
constexpr int kRN = 4;           // columns per thread
constexpr int kGroups = kCT / kRN;
// Minimum resident blocks per SM in the kernels' __launch_bounds__.  Without
// a minimum, ptxas aimed at 64 registers and spilled or not depending on
// small edits elsewhere (the slab kernel 190 -> 220 ms, the contraction
// kernel 14.2 -> 15.2 ms on xi_ell; H100 80GB HBM3, 700 W).  With one it
// takes 79-83 registers, no spill, at every edit tried.  Three 64-row
// blocks is what the bench tables' shared memory allows (~70 KB each);
// the wide slab grid's 160 bins allow two.
constexpr int kMinBlocks = 3;
constexpr int kMinBlocksSlab = 2;

static_assert(kThreads == (kTB / kRM) * kGroups, "thread layout");

struct TableArgs {
  QuadArgs q;           // occupation quadrature (not read by the contraction)
  const float* ft;      // (k_pad, c_pad): ft[j, k*nbp + i] = F[k, i, j]
                        // (auto) or ft[j, k] = F[k, j] (cross)
  float* out_total;     // (B,), or null: not stored
  float* out_xi;        // row b's statistics at out_xi + b * out_stride
  int nb, n_xi, nbp, k_pad, c_pad, is_auto;
  int out_stride;
};

// Shared-memory layout (floats), per block:
//   sN   [k_pad_max][kTB]     per-bin densities, bin-major
//   sF   [kKT][kCT]           staged tile of ft
//   sP   [kTB][kGroups]       per-thread-column-group partial sums
//   sQ   [kTB][nxi_max]       quadratic forms / matvecs per statistic
//   sPar [kParTerms][kTB]     per-row parameter terms (occupation kernels)
//   sTot [kTB]                sum_i n_i per row
inline size_t smem_floats(int k_pad_max, int nxi_max) {
  return (size_t)k_pad_max * kTB + kKT * kCT + kTB * kGroups +
         (size_t)kTB * nxi_max + (kParTerms + 1) * kTB;
}

struct Smem {
  float* sN;
  float* sF;
  float* sP;
  float* sQ;
  float* sPar;
  float* sTot;
};

__device__ inline Smem carve(float* base, int k_pad_max, int nxi_max) {
  Smem s;
  s.sN = base;
  s.sF = s.sN + (size_t)k_pad_max * kTB;
  s.sP = s.sF + kKT * kCT;
  s.sQ = s.sP + kTB * kGroups;
  s.sPar = s.sQ + (size_t)kTB * nxi_max;
  s.sTot = s.sPar + kParTerms * kTB;
  return s;
}

inline bool check_table(const TableArgs& t) {
  return !(t.nbp % kRN || t.k_pad % kKT || t.c_pad % kCT ||
           t.k_pad < t.nbp || t.nbp < t.nb || t.n_xi < 1 || t.nb < 1 ||
           t.out_stride < t.n_xi);
}

// xi and sum_i n_i of one table for the block's rows.  On entry s.sN holds
// n[b, i] bin-major (0 for padded bins and masked rows) and a
// __syncthreads() has passed since it was written; on exit the outputs are
// stored and the block is synchronised, so sN may be overwritten.
__device__ inline void contract_table(const TableArgs& t, int batch,
                                      int row0, const Smem& s) {
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
    const int k = item - b * t.n_xi;
    if (row0 + b < batch) {
      const float tot = s.sTot[b];
      t.out_xi[(size_t)(row0 + b) * t.out_stride + k] =
          t.is_auto ? sQ[item] / (tot * tot) : sQ[item] / tot;
    }
  }
  if (t.out_total != nullptr && tid < kTB && row0 + tid < batch)
    t.out_total[row0 + tid] = s.sTot[tid];
  __syncthreads();   // before the caller reuses sN, sQ and sTot
}

}  // namespace tabcorr
