// The contraction kernel (B3) on bfloat16 tables, for Hopper (sm_90a).
//
// Replaces tabcorr_tpu/ops/fused.py:make_fused_contraction (pallas_call at
// :204) built on a bfloat16 table, the route of tabcorr_tpu's
// make_predictor(dtype=jnp.bfloat16, engine="fused") for a TabCorr (through
// make_fused_predictor) and for an Interpolator (every node's matrix
// stacked on the statistic axis): ngal (B, n_bins) -> total (B,), xi (B,
// n_xi), with
//
//     auto:  xi[b, k] = sum_i t[b, k, i] n[b, i] / (sum_i n[b, i])^2,
//            t[b, k, i] = sum_j F[k, i, j] n[b, j]
//     cross: xi[b, k] = sum_j F[k, j] n[b, j] / sum_j n[b, j].
//
// The products t = n F run on the tensor cores as BF16
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, bfloat16 operands
// with float32 accumulators: A is a tile of the block's density rows,
// staged in shared memory, B the matrix as the host stored it once
// (ops/fused.py:bf16_table_constants), one row of K = bins per column of
// t, K contiguous, as `.col` wants it (auto: column k * ni + i holds
// F[k, i, :]; cross: column k holds F[k, :]).  Bins are padded to kp (a
// multiple of 16) and each statistic's column block to ni (a multiple of
// 8) with zeros, and padded bins carry n = 0.  The auto fold
// sum_i t[k, i] n_i runs on the float32 accumulators (t is not rounded to
// bfloat16 first, as tabcorr_tpu's kernel would round it); sum_i n_i and
// the division are float32.  Only total and xi are rounded to bfloat16
// (to nearest), the route's output type.
//
// What bounds it on an H100: the BF16 tensor cores.  Per density row the
// auto contraction costs 2 n_xi ni kp operations (2 x 2688 x 64 x 64 =
// 22 MFLOP on the 64-node grid) against 2 kp bytes in and 2 (n_xi + 1)
// bytes out: hundreds of operations per byte, above the card's ~295.
//
// What the design does about it (a simple kernel first: no wgmma, TMA or
// cp.async ring yet): a block of 4 warps owns 64 x MT density rows, each
// warp 16 x MT of them.  Where kp <= 160 (KS = kp / 16 k-steps, a
// template) every warp holds its rows' A fragments for the whole K in
// registers, loaded from shared memory once, and reuses each B fragment it
// loads for its MT = 2 m-tiles; wider tables (cross tables of many bins)
// read A from shared memory at every k-step, MT = 1.  B fragments come
// from device memory through L1 (two 32-bit loads a lane a k-step; the
// block's four warps read the same ones); the matrices of the 60-bin grids
// fit in the 50 MB L2.  The grid's second dimension splits the statistics,
// so that small batches still fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tabcorr {
namespace bf16 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Args {
  const __nv_bfloat16* ngal;     // (batch, nb)
  const __nv_bfloat16* bt;       // (n_cols, kp)
  __nv_bfloat16* total;          // (batch,)
  __nv_bfloat16* xi;             // (batch, n_xi)
  int batch, nb, kp, n_xi, ni, is_auto;
  int units_per_block;           // statistics (auto) or n8 tiles (cross)
  int n_units;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Shared-memory row stride (elements) of the density tile: kp + 8, so
// that the 8 rows of a fragment load start 4 banks apart.
__host__ __device__ __forceinline__ int row_stride(int kp) { return kp + 8; }

// The A fragment of k-step `ks` for the 16 rows at `rows` of the tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* rows, int stride,
                                       int ks, int g, int tig) {
  const __nv_bfloat16* p = rows + g * stride + ks * 16 + tig * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * stride);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * stride + 8);
}

// One n8 column tile for the warp's MT m-tiles: c[m] = A_m (16 x kp) times
// columns col0..col0+7 of B.  KS > 0: A fragments from registers
// (a[m][ks]); KS == 0: loaded from shared memory at each of kp / 16 steps.
template <int KS, int MT>
__device__ __forceinline__ void column_tile(
    float (&c)[MT][4], const uint32_t (&a)[MT][KS > 0 ? KS : 1][4],
    const __nv_bfloat16* rows, int stride, const __nv_bfloat16* bcol,
    int kp, int g, int tig) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
    c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.f;
  if constexpr (KS > 0) {
    uint32_t b[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      b[ks][0] = ldg32(bcol + ks * 16);
      b[ks][1] = ldg32(bcol + ks * 16 + 8);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_bf16(c[m], a[m][ks], b[ks][0], b[ks][1]);
  } else {
    for (int ks = 0; ks < kp / 16; ++ks) {
      const uint32_t b0 = ldg32(bcol + ks * 16);
      const uint32_t b1 = ldg32(bcol + ks * 16 + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        load_a(af, rows + m * 16 * stride, stride, ks, g, tig);
        mma_bf16(c[m], af, b0, b1);
      }
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

template <int KS, int MT>
__global__ void __launch_bounds__(kThreads)
    contraction_bf16_kernel(const Args args) {
  constexpr int kRows = kWarps * 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = row_stride(args.kp);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sums = reinterpret_cast<float*>(tile + kRows * stride);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int row0 = blockIdx.x * kRows;

  // Stage the density rows; bins nb..kp and rows past the batch are 0.
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    const __nv_bfloat16* src = args.ngal + (size_t)row * args.nb;
    for (int k = lane; k < args.kp; k += 32)
      tile[r * stride + k] = (row < args.batch && k < args.nb)
                                 ? src[k]
                                 : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  // Row totals, float32.
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float s = 0.f;
    for (int k = 0; k < args.nb; ++k)
      s += __bfloat162float(tile[r * stride + k]);
    const int row = row0 + r;
    if (blockIdx.y == 0 && row < args.batch)
      args.total[row] = __float2bfloat16_rn(s);
    sums[r] = s;
  }
  __syncthreads();

  const __nv_bfloat16* rows = tile + warp * 16 * MT * stride;
  uint32_t a[MT][KS > 0 ? KS : 1][4];
  if constexpr (KS > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        load_a(a[m][ks], rows + m * 16 * stride, stride, ks, g, tig);
  }
  // Each lane's rows: m-tile m, half h -> tile row warp*16*MT + m*16 + g
  // + 8h.
  float tot[MT][2];
  int out_row[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 * MT + m * 16 + g + 8 * h;
      tot[m][h] = sums[r];
      out_row[m][h] = row0 + r;
    }

  const int u0 = blockIdx.y * args.units_per_block;
  const int u1 = min(u0 + args.units_per_block, args.n_units);
  float c[MT][4];
  if (args.is_auto) {
    for (int k = u0; k < u1; ++k) {
      float part[MT][2] = {};
      for (int t = 0; t < args.ni; t += 8) {
        const int col = k * args.ni + t;
        column_tile<KS, MT>(c, a, rows, stride,
                            args.bt + (size_t)(col + g) * args.kp + tig * 2,
                            args.kp, g, tig);
        // Fold with n_i at the lane's columns i = t + 2 tig, t + 2 tig + 1.
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 n2 = *reinterpret_cast<const __nv_bfloat162*>(
                rows + (m * 16 + g + 8 * h) * stride + t + tig * 2);
            part[m][h] += c[m][2 * h] * __low2float(n2) +
                          c[m][2 * h + 1] * __high2float(n2);
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float q = quad_sum(part[m][h]);
          if (tig == 0 && out_row[m][h] < args.batch)
            args.xi[(size_t)out_row[m][h] * args.n_xi + k] =
                __float2bfloat16_rn(q / (tot[m][h] * tot[m][h]));
        }
    }
  } else {
    for (int u = u0; u < u1; ++u) {
      const int col = u * 8;
      column_tile<KS, MT>(c, a, rows, stride,
                          args.bt + (size_t)(col + g) * args.kp + tig * 2,
                          args.kp, g, tig);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = col + tig * 2 + e;
            if (k < args.n_xi && out_row[m][h] < args.batch)
              args.xi[(size_t)out_row[m][h] * args.n_xi + k] =
                  __float2bfloat16_rn(c[m][2 * h + e] / tot[m][h]);
          }
    }
  }
}

template <int KS, int MT>
int launch(const Args& args, int units_per_block, cudaStream_t stream) {
  constexpr int kRows = kWarps * 16 * MT;
  auto kernel = contraction_bf16_kernel<KS, MT>;
  const size_t smem = (size_t)kRows * row_stride(args.kp) * 2 +
                      kRows * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left as the next launch's error
    return (int)err;
  }
  Args a = args;
  a.units_per_block = units_per_block;
  const dim3 grid((args.batch + kRows - 1) / kRows,
                  (args.n_units + units_per_block - 1) / units_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_ks(const Args& args, int units_per_block, cudaStream_t stream) {
  return launch<KS, (KS > 0 ? 2 : 1)>(args, units_per_block, stream);
}

}  // namespace bf16
}  // namespace tabcorr

extern "C" {

// Launch the bfloat16 contraction on `stream`: `ngal` (batch, nb) and the
// matrix `bt` (n_cols, kp) in the layout of
// ops/fused.py:bf16_table_constants, both contiguous bfloat16 on
// `device`; `out_total` (batch,) and `out_xi` (batch, n_xi) bfloat16.
// `units_per_block` statistics (auto) or 8-column tiles (cross) per block
// along the grid's second dimension.  Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously.
int tabcorr_contraction_bf16(const void* ngal, int batch, int nb, int kp,
                             const void* bt, int n_xi, int ni, int is_auto,
                             int units_per_block, void* out_total,
                             void* out_xi, int device, void* stream) {
  using namespace tabcorr::bf16;
  if (batch < 0 || nb < 1 || kp % 16 != 0 || kp < nb || n_xi < 1 ||
      units_per_block < 1 ||
      (is_auto && (ni % 8 != 0 || ni < nb || ni > kp)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (batch == 0) return 0;
  Args args = {};
  args.ngal = static_cast<const __nv_bfloat16*>(ngal);
  args.bt = static_cast<const __nv_bfloat16*>(bt);
  args.total = static_cast<__nv_bfloat16*>(out_total);
  args.xi = static_cast<__nv_bfloat16*>(out_xi);
  args.batch = batch;
  args.nb = nb;
  args.kp = kp;
  args.n_xi = n_xi;
  args.ni = ni;
  args.is_auto = is_auto;
  args.n_units = is_auto ? n_xi : (n_xi + 7) / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kp / 16) {
    case 1: return launch_ks<1>(args, units_per_block, s);
    case 2: return launch_ks<2>(args, units_per_block, s);
    case 3: return launch_ks<3>(args, units_per_block, s);
    case 4: return launch_ks<4>(args, units_per_block, s);
    case 5: return launch_ks<5>(args, units_per_block, s);
    case 6: return launch_ks<6>(args, units_per_block, s);
    case 7: return launch_ks<7>(args, units_per_block, s);
    case 8: return launch_ks<8>(args, units_per_block, s);
    case 9: return launch_ks<9>(args, units_per_block, s);
    case 10: return launch_ks<10>(args, units_per_block, s);
    default: return launch_ks<0>(args, units_per_block, s);
  }
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
