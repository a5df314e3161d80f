// 3xTF32 tensor-core building blocks of the 'scaled' tier: the grid_tc
// kernel (grid.cu) on mma.sync, and the TF32 split that the slab_tc kernel
// (slab.cu, on wgmma) applies to its densities as it loads them.
//
// A float32 x is split into two TF32 values, hi = rna(x) and lo =
// rna(x - hi) (round to nearest, ties away from zero, to 10 explicit
// mantissa bits, as cvt.rna.tf32.f32); |x - hi - lo| <= 2^-22 |x|.  A product is
// taken as a_lo b_hi + a_hi b_lo + a_hi b_hi on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, each TF32 product
// exact; the dropped a_lo b_lo term is below 2^-22 of the product.
// tests/test_torch_tf32x3.py emulates these kernels on the host with the
// same rounding (bit for bit on finite values).
//
// grid_tc's block: 512 threads (16 warps) own a tile of
// TB batch rows x kCT = 128 columns of a GEMM T = A B, A = the block's
// density-side operand (densities or pair weights, float32, split into
// hi/lo fragments in shared memory once per staged tile, or split as each
// fragment is loaded where shared memory holds no room for the split
// copies), B = the constant
// matrix (float32 in device memory, staged through a cp.async ring and
// split into hi/lo when each fragment is loaded into registers).  B is not
// split on the host: hi and lo arrays would double the bytes every block
// streams from L2 (and grid64's packed matrix, 20.6 MB, would no longer
// sit comfortably in the 50 MB L2), and the device split is the same
// rounding bit for bit.  The K loop runs in chunks of at most kKT = 32 (4 k-steps of 8);
// each chunk accumulates into a fresh fragment, which the caller adds to a
// running sum in registers (float32 or double): the tensor cores'
// accumulation need not round to nearest, so no sum is chained through
// them for more than 12 MMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace tabcorr {
namespace tc {

constexpr int kThreads = 512;    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 32;          // K rows per staged chunk (4 k-steps)
constexpr int kCT = 128;         // columns per tile
constexpr int kBS = kCT + 8;     // staged B row stride (floats): the lanes
                                 // of a fragment load hit 32 banks
constexpr int kStageFloats = kKT * kBS;

// x rounded to TF32, to nearest with ties away from zero, for finite x:
// cvt.rna.tf32.f32's result in two integer instructions (ptxas expands
// cvt.rna with a test for infinities and NaNs).  A non-finite
// density never needs it: a NaN or infinite n also makes sum_i n_i, the
// statistics' denominator, NaN or infinite, and the constants are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on one m16n8k8 TF32 tile (fragments in the PTX ISA's layout).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

using tabcorr::cp_async16;
using tabcorr::cp_async_commit;
using tabcorr::cp_async_wait;

// Start copying rows [0, n_rows) x kCT columns of B (row stride `stride`
// floats, 16-byte aligned) into the stage `dst` (row stride kBS).  Every
// thread of the block (NT threads) calls it; the caller commits the group.
template <int NT = kThreads>
__device__ __forceinline__ void stage_b(float* dst, const float* src,
                                        size_t stride, int n_rows) {
  for (int l = threadIdx.x; l < n_rows * (kCT / 4); l += NT) {
    const int r = l / (kCT / 4);
    const int c4 = l % (kCT / 4);
    cp_async16(dst + r * kBS + c4 * 4, src + r * stride + c4 * 4);
  }
}

// The A operand's fragments from shared memory, split into hi/lo, in
// fragment order (conflict-free 16-byte loads): for k-step s and m16
// tile m, lane (g = lane / 4, t = lane % 4) holds float4 {A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]} at float4 index (s * n_m16 +
// m) * 32 + lane, hi and lo in two arrays; m0 is the warp's first m16
// tile and s0 the chunk's first k-step.
struct FragOrderA {
  const float4* hi;
  const float4* lo;
  int n_m16, s0, m0;
  __device__ __forceinline__ void operator()(int ks, int mi, uint32_t (&h)[4],
                                             uint32_t (&l)[4]) const {
    const int idx = ((s0 + ks) * n_m16 + m0 + mi) * 32 + (threadIdx.x & 31);
    const float4 vh = hi[idx];
    const float4 vl = lo[idx];
    h[0] = __float_as_uint(vh.x);
    h[1] = __float_as_uint(vh.y);
    h[2] = __float_as_uint(vh.z);
    h[3] = __float_as_uint(vh.w);
    l[0] = __float_as_uint(vl.x);
    l[1] = __float_as_uint(vl.y);
    l[2] = __float_as_uint(vl.z);
    l[3] = __float_as_uint(vl.w);
  }
};

// The A operand's fragments straight from float32 densities in shared
// memory, bin-major at a row stride of STRIDE floats, split as they are
// loaded: lane (g, t) reads A[g][t], A[g + 8][t], A[g][t + 4] and A[g +
// 8][t + 4]; STRIDE % 32 == 4 puts the 32 lanes of each load in 32 banks.
// m0 is the warp's first m16 tile and s0 the chunk's first k-step.
template <int STRIDE>
struct SplitOnLoadA {
  static_assert(STRIDE % 32 == 4, "conflict-free fragment loads");
  const float* n;
  int s0, m0;
  __device__ __forceinline__ void operator()(int ks, int mi, uint32_t (&h)[4],
                                             uint32_t (&l)[4]) const {
    const int lane = threadIdx.x & 31;
    const float* p = n + ((s0 + ks) * 8 + (lane & 3)) * STRIDE +
                     (m0 + mi) * 16 + (lane >> 2);
    split_tf32(p[0], h[0], l[0]);
    split_tf32(p[8], h[1], l[1]);
    split_tf32(p[4 * STRIDE], h[2], l[2]);
    split_tf32(p[4 * STRIDE + 8], h[3], l[3]);
  }
};

// One k-step (8 K rows) of a warp's MT x NT fragments: A from load_a, B
// from the staged tile (split here), 3 MMAs per fragment.
template <int MT, int NT, bool SPLIT, class LoadA>
__device__ __forceinline__ void kstep_mma(float (&acc)[MT][NT][4],
                                          float (&acc_lo)[MT][NT][4],
                                          const LoadA& load_a,
                                          const float* sB, int n0, int ks,
                                          int g, int t) {
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) load_a(ks, mi, ah[mi], al[mi]);
  const float* b_row0 = sB + (ks * 8 + t) * kBS + n0 + g;
  const float* b_row1 = b_row0 + 4 * kBS;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    uint32_t bh[2], bl[2];
    split_tf32(b_row0[ni * 8], bh[0], bl[0]);
    split_tf32(b_row1[ni * 8], bh[1], bl[1]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (SPLIT) {
        mma_tf32(acc_lo[mi][ni], al[mi], bh);
        mma_tf32(acc_lo[mi][ni], ah[mi], bl);
        mma_tf32(acc[mi][ni], ah[mi], bh);
      } else {
        mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh, bl);
      }
    }
  }
}

// One chunk of `n_steps` (<= 4) k-steps for one warp's MT x NT fragments:
// acc (fresh, zeroed here) = A[the warp's rows, k-steps of load_a] x
// B[stage rows, columns n0..].  SPLIT: the hi*hi products chain through
// `acc` and the two small products through `acc_lo`, which the caller
// adds; a truncating accumulation then loses 4, not 12, roundings of the
// full-size partial per chunk.
template <int MT, int NT, bool SPLIT, class LoadA>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4],
                                          float (&acc_lo)[MT][NT][4],
                                          const LoadA& load_a,
                                          const float* sB, int n0,
                                          int n_steps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
        if (SPLIT) acc_lo[mi][ni][e] = 0.f;
      }
  // A full chunk takes the branch-free path, so that the compiler can
  // load the next k-step's fragments under the current one's MMAs.
  if (n_steps == kKT / 8) {
#pragma unroll
    for (int ks = 0; ks < kKT / 8; ++ks)
      kstep_mma<MT, NT, SPLIT>(acc, acc_lo, load_a, sB, n0, ks, g, t);
    return;
  }
#pragma unroll
  for (int ks = 0; ks < kKT / 8; ++ks)
    if (ks < n_steps)
      kstep_mma<MT, NT, SPLIT>(acc, acc_lo, load_a, sB, n0, ks, g, t);
}

// The error code of a failed runtime call made before a launch, with the
// runtime's last-error state cleared, so that the next launch's
// cudaGetLastError() does not report it again.
inline int setup_error(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

}  // namespace tc
}  // namespace tabcorr
