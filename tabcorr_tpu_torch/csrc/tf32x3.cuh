// The TF32 split of the 'scaled' tier's 3xTF32 products, and the cp.async
// staging of a float32 tile that the grid kernel (grid.cu) streams.
//
// A float32 x is split into two TF32 values, hi = rna(x) and lo =
// rna(x - hi) (round to nearest, ties away from zero, to 10 explicit
// mantissa bits, as cvt.rna.tf32.f32); |x - hi - lo| <= 2^-22 |x|.  A
// product is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, each TF32 product
// exact; the dropped a_lo b_lo term is below 2^-22 of the product.  The
// kernels on wgmma split their densities with split_tf32 as they load
// them: slab_tc (slab.cu) and the bundle kernel's tensor-core route
// (bundle.cu); their constant matrices are split on the host
// (ops/fused.py:split_tf32, the same rounding bit for bit).
// tests/test_torch_tf32x3.py emulates the split and slab_tc's products on
// the host.
//
// stage_b copies rows of a float32 matrix, kCT = 128 columns at a time,
// into a shared-memory tile of row stride kBS through cp.async
// (cp_async.cuh); the grid kernel streams its packed matrix in such tiles
// of kKT = 32 rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace tabcorr {
namespace tc {

constexpr int kKT = 32;          // K rows per staged chunk
constexpr int kCT = 128;         // columns per tile
constexpr int kBS = kCT + 8;     // staged row stride (floats): the lanes
                                 // of a fragment load hit 32 banks

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

// Start copying rows [0, n_rows) x kCT columns of B (row stride `stride`
// floats, 16-byte aligned) into the stage `dst` (row stride kBS).  Every
// thread of the block (NT threads) calls it; the caller commits the group.
template <int NT>
__device__ __forceinline__ void stage_b(float* dst, const float* src,
                                        size_t stride, int n_rows) {
  for (int l = threadIdx.x; l < n_rows * (kCT / 4); l += NT) {
    const int r = l / (kCT / 4);
    const int c4 = l % (kCT / 4);
    cp_async16(dst + r * kBS + c4 * 4, src + r * stride + c4 * 4);
  }
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
