// Slab grid kernels (B4) for Hopper (sm_90a): every node of a stacked
// Interpolator grid of one halo binning, per node and without the spline,
// for a batch of parameter vectors.
//
// Replace: tabcorr_tpu/ops/fused.py:make_fused_grid_predictor with
// layout='slab' (the node-streamed slab kernel; tabcorr_tpu's route for
// auto grids whose packed pair row exceeds 8192 lanes, i.e. more than 127
// bins).  They compute what that kernel computes, not its block structure:
//
//   n[b, i]            zheng07 occupation quadrature, optionally with the
//                      Heaviside assembly-bias decoration (zheng07.cuh),
//                      once per row, or for any other model (code 2)
//                      read from densities computed beforehand
//                      (occupation.cu or tensor ops);
//   xi[b, node, k]   = n_b^T F_node,k n_b / (sum_i n_bi)^2   (auto)
//                    = (F_node n_b)_k / sum_i n_bi           (cross)
//
// The grid spline runs afterwards in tensor ops (predictor.py), as
// tabcorr_tpu's XLA spline follows its slab kernel.
//
// slab_kernel is the 'elementwise' tier (FP32 on the CUDA cores), over
// the block-triangular half of contract.cuh
// (ops/fused.py:slab_tc_table_constants); slab_tc_kernel the 'scaled'
// tier (3xTF32 on wgmma, below), over the same columns split into TF32
// halves once on the host (ops/fused.py:slab_split_table_constants).
//
// What bounds them on an H100: FP32 FMA (slab_kernel), the tensor cores
// (slab_tc_kernel).  At the 64-node wide grid (160 bins, 42 rows per
// node) a parameter vector costs 64 x 42 x 12,880 = 3.5e7 multiply-adds
// over the symmetric half against 1,600 occupation evaluations, with 28
// bytes of parameters in and 10,756 bytes out.  The 147 MB of node
// matrices (294 MB split) do not fit in the 50 MB L2, but the blocks in
// flight walk the nodes in the same order at about the same pace, so each
// node is read from device memory about once per wave of blocks.
//
// What slab_kernel's design does about it:
// * A block owns 64 batch rows.  Their densities are computed into shared
//   memory once (40 KB at 160 bins) and reused by every node.
// * The nodes run through contract.cuh's contract_fp32() (8 x 8 register
//   tiles, fmaf) as one stream of column tiles, the cp.async ring running
//   on across node boundaries; sums run over nb = 160 terms, short enough
//   for float32 (tabcorr_tpu's packed form would sum 12,880 pair terms per
//   column).
// * Each node's 64 x 42 statistics go from shared memory straight to
//   device memory: the block's whole output (64 x 2688 floats) would not
//   fit in shared memory.  No bf16 pass groups, no 128-lane packing, no
//   row permutation.

#include <cuda_runtime.h>
#include <math.h>

#include "contract.cuh"
#include "hopper.cuh"

namespace {

using namespace tabcorr;

struct SlabArgs {
  const float* params;   // (B, hod.n_params); code 2: unread (q.dens)
  int batch;
  HodArgs hod;
  QuadArgs q;
  HalfTable h;           // the n_nodes nodes' matrices
  TableOut out;          // total (B,), xi (B, n_nodes, n_xi)
  int stage_steps;       // slab_kernel's ring stage, in K steps
};

// Shared-memory layout (floats), per block: sN [nb8][TB], the ring, sXi
// [TB][n_xi], sPar [kParTerms][TB], sTot [TB]
// (contract.cuh:fp32_smem_floats).
template <int TB, int MODEL>
__global__ void __launch_bounds__(2 * TB, kMinBlocksSlab)
slab_kernel(const SlabArgs args) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sRing = sN + (size_t)args.h.nb8 * TB;
  float* sXi = sRing + kStages * args.stage_steps * 8 * kCT;
  float* sPar = sXi + (size_t)TB * args.h.n_xi;
  float* sTot = sPar + kParTerms * TB;
  const int row0 = blockIdx.x * TB;

  param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  occupation_phase<TB, 2 * TB, MODEL>(args.q, args.h.nb8, args.batch, row0,
                                      args.hod, sPar, sN);
  __syncthreads();
  contract_fp32<TB>(args.h, args.out, args.batch, row0, args.stage_steps,
                        sN, sRing, sXi, sTot);
}

// Set the kernel's dynamic shared memory and launch it over the batch in
// blocks of `tb` rows.
template <class Kernel>
int launch_slab(Kernel kernel, const SlabArgs& args, int tb, int threads,
                size_t smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  kernel<<<(args.batch + tb - 1) / tb, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// slab_tc: the 'scaled' tier, 3xTF32 on wgmma.
//
// What bounds it: the tensor cores (three TF32 products per multiply-add
// at the dense TF32 rate), unless the B operand's traffic from L2 or the
// instructions around the MMAs get in the way; on the wide grid it is the
// latter (PERF.md; scripts/torch_slab_probe.py).  What the design does:
//
// * B is split once, on the host (ops/fused.py:slab_split_table_constants):
//   every k-step (8 K rows) of every 128-column tile of every node is a
//   stage of 8 KB, its TF32 hi then lo half, each K-major in the 32-byte
//   swizzle that a wgmma descriptor reads (hopper.cuh:desc_kmajor_sw32),
//   stored in the order the kernel consumes them.  The kernel splits no B
//   element, and its products are the old mma.sync kernel's.
// * A producer warpgroup (one thread) streams the stages through a ring
//   of `stages` slots with TMA bulk copies, a full and an empty mbarrier a
//   slot; the ring runs on across column tiles and nodes.  Each block is a
//   cluster of its own: B from a resident ring is no faster on the wide
//   grid, so L2 is not the limit, and clusters of 2 blocks sharing each
//   stage by TMA multicast were slower (PERF.md;
//   scripts/torch_slab_probe.py).
// * WGS consumer warpgroups own 64 batch rows each (TB = 64 WGS rows a
//   block) and all 128 columns of a tile: per k-step three
//   wgmma.mma_async m64n128k8 .tf32, A from registers (the densities'
//   fragment, split into hi/lo as it is loaded from shared memory; the
//   densities stay float32 for the epilogue), B from the ring: lo*hi and
//   hi*lo into one accumulator, hi*hi into another, both fresh for each
//   chunk of kChunkSteps k-steps (32 K rows), as in the old kernel.  A
//   k-step's group is waited for one k-step later (the slot is then
//   released), so the tensor cores hold the next group meanwhile.  With
//   two consumer warpgroups the producer gives its registers to them
//   (setmaxnreg).
// * Auto mode folds each chunk straight into the epilogue's sums: each
//   lane keeps, for its two batch rows (lane (g, t): rows g and g + 8 of
//   its warp) and each n8 tile, n_i t_i over its two bins (32 registers,
//   where a running sum of the chunks would take 64).  At a tile's end the
//   quad's shares are added in shuffles and go to the row's statistics in
//   shared memory, one lane per row and statistic, so a row's sums run in
//   column order and need no block barrier; a node's statistics go from
//   shared memory to device memory per warp.  Cross mode keeps the float32
//   running sum of the chunks and stores it divided by sum_i n_i.
//   sum_i n_i is summed in double by the row's four lanes.
// * Rows past the batch end hold zero densities and are never stored.

namespace stc {
constexpr int kCols = 128;                       // columns of a tile
constexpr int kStageFloats = 2 * kCols * 8;      // one k-step: hi, lo
constexpr int kStageBytes = 4 * kStageFloats;    // 8192
constexpr int kMaxStages = 16;
// K steps of 8 rows per fresh accumulator: 4 (32 K rows, the chunks of
// the mma.sync kernel before it and of the tests' emulation; 8 misses the
// 'scaled' contract, 2 is slower).
constexpr int kChunkSteps = 4;
// Registers a thread of the producer and of a consumer warpgroup keeps
// after setmaxnreg (two consumer warpgroups, 384 threads, one block per
// SM: 128 x 24 + 256 x 240 <= 65,536).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

struct Args {
  const float* params;   // (B, hod.n_params); code 2: unread (q.dens)
  int batch;
  HodArgs hod;
  QuadArgs q;
  const float* b;        // (n_nodes * node_steps) stages of kStageFloats
  const int* ct_step0;   // (n_ct,) first K step of column tile ct
  const int* ct_steps;   // (n_ct,) its K steps (stages)
  const int* col_k;      // (n_ct * 16,) auto: statistic of each n8 tile
  const int* col_i0;     // (n_ct * 16,) auto: its first bin
  int node_steps, n_nodes, n_xi, n_ct, is_auto, nb, nb8;
  int stages;            // ring slots
  TableOut out;          // total (B,), xi (B, n_nodes, n_xi)
};

// Dynamic shared memory of a block: the ring (1024-byte aligned slots),
// full and empty barriers, sN [nb8][TB] (swizzled_index), sXi [TB][n_xi]
// and sPar [kParTerms][TB].
inline size_t smem_bytes(int wgs, int stages, int nb8, int n_xi) {
  const size_t tb = 64 * (size_t)wgs;
  return (size_t)stages * (kStageBytes + 16) +
         4 * ((size_t)nb8 * tb + tb * n_xi + kParTerms * tb);
}

// d (+)= a b over the tile's 128 columns, one instruction (two of 64
// columns were slower on the wide grid).
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                   uint64_t desc, int scale_d) {
  hopper::wgmma_tf32_n128(d, a, desc, scale_d);
}

// The producer: one thread streams every stage of every node through the
// ring, then waits until the consumers have released each slot for the
// last time.
__device__ void produce(const Args& a, uint32_t ring, uint32_t full,
                        uint32_t empty) {
  const int n_stages = a.n_nodes * a.node_steps;
  int slot = 0;
  uint32_t phase = 0;
  for (int s = 0; s < n_stages; ++s) {
    hopper::mbar_wait(empty + 8 * slot, phase ^ 1);
    hopper::mbar_arrive_expect_tx(full + 8 * slot, kStageBytes);
    hopper::bulk_load(ring + slot * kStageBytes,
                      a.b + (size_t)s * kStageFloats, kStageBytes,
                      full + 8 * slot);
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  for (int s = 0; s < min(a.stages, n_stages); ++s) {
    hopper::mbar_wait(empty + 8 * slot, phase ^ 1);
    if (++slot == a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// n[r0, i], n[r0, i + 1], n[r1, i], n[r1, i + 1] from sN.
template <int TB>
__device__ __forceinline__ void load_densities(const float* sN, int i, int r0,
                                               int r1, float (&n)[4]) {
  n[0] = sN[swizzled_index<TB>(i, r0)];
  n[1] = sN[swizzled_index<TB>(i + 1, r0)];
  n[2] = sN[swizzled_index<TB>(i, r1)];
  n[3] = sN[swizzled_index<TB>(i + 1, r1)];
}

// A consumer warpgroup `wg`: rows [64 wg, 64 wg + 64) of the block.
template <int TB, bool AUTO>
__device__ void consume(const Args& a, int wg, int row0, uint32_t ring,
                        uint32_t full, uint32_t empty, const float* sN,
                        float* sXi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // warp's rows
  const int r0 = wrow + g, r1 = r0 + 8;                      // this lane's
  const TableOut& out = a.out;

  // sum_i n_i of rows r0 and r1 in double: lane t takes bins t, t + 4, ...
  double s0 = 0.0, s1 = 0.0;
  for (int i = t; i < a.nb; i += 4) {
    s0 += sN[swizzled_index<TB>(i, r0)];
    s1 += sN[swizzled_index<TB>(i, r1)];
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float tot0 = static_cast<float>(s0);
  const float tot1 = static_cast<float>(s1);
  if (out.total != nullptr && t == 0) {
    if (row0 + r0 < a.batch) out.total[row0 + r0] = tot0;
    if (row0 + r1 < a.batch) out.total[row0 + r1] = tot1;
  }
  float* xi_w = sXi + (size_t)wrow * a.n_xi;   // the warp's 16 rows
  if constexpr (AUTO) {
    for (int item = lane; item < 16 * a.n_xi; item += 32) xi_w[item] = 0.f;
    __syncwarp();
  }

  // Release a slot once this warp's MMAs that read it are complete: one
  // arrival per warp on the slot's empty barrier.
  auto release = [&](int slot) {
    if (lane == 0) hopper::mbar_arrive(empty + 8 * slot);
  };

  // The A fragments' offsets in sN at K rows t and t + 4 of any k-step
  // (swizzled_index: the flip depends on the bin's last two bits only).
  const int a0 = swizzled_index<TB>(t, r0), a1 = swizzled_index<TB>(t, r1);

  // Auto: the densities n[r0 | r1, i0 + 2t (+ 1)] of the bin tile i0 last
  // read (load_densities; a column tile holds one or two bin tiles at
  // width 8).
  int n_i0 = -1;
  float nc[4] = {0.f, 0.f, 0.f, 0.f};

  // acc (hi*hi) and acc_lo (the small products) of the current chunk:
  // element 4 j + e is row (e < 2 ? r0 : r1), column 8 j + 2 t + e % 2 of
  // the tile.  Auto mode folds each chunk into vp, the lane's share of
  // sum_i n_i t[b, (k, i)] over its two bins of each n8 tile (vp[2 j + h]:
  // row h ? r1 : r0); cross mode sums the chunks in run.
  float acc[64], acc_lo[64];
  float vp[AUTO ? 32 : 1], run[AUTO ? 1 : 64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc_lo[e] = 0.f;
  int slot = 0;
  uint32_t phase = 0;
  for (int node = 0; node < a.n_nodes; ++node) {
    for (int ct = 0; ct < a.n_ct; ++ct) {
      const int step0 = __ldg(a.ct_step0 + ct);
      const int steps = __ldg(a.ct_steps + ct);
      // Auto: the tile's column tables, one entry a lane (col_i0 of n8
      // tile l in lane l, col_k in lane 16 + l), loaded under the MMAs and
      // read by shuffles.
      const int col = AUTO ? __ldg((threadIdx.x & 16 ? a.col_k : a.col_i0) +
                                   ct * 16 + (threadIdx.x & 15))
                           : 0;
      // Auto: bit j of `change` (j = 1..15) is set where n8 tile j starts
      // at another bin than tile j - 1, so the fold below reloads its
      // densities without waiting for a shuffle at every n8 tile.
      // Bit 16 + j of `paired` (j even) is set where n8 tiles j and j + 1
      // hold one statistic.
      unsigned change = 0, paired = 0;
      int i0_first = 0;
      if constexpr (AUTO) {
        const int up = __shfl_up_sync(0xffffffffu, col, 1);
        const int down = __shfl_down_sync(0xffffffffu, col, 1);
        change = __ballot_sync(0xffffffffu, lane > 0 && lane < 16 && col != up);
        paired = __ballot_sync(0xffffffffu,
                               lane >= 16 && !(lane & 1) && col == down);
        i0_first = __shfl_sync(0xffffffffu, col, 0);
      }
      for (int q0 = 0; q0 < steps; q0 += kChunkSteps) {
        const int n = min(kChunkSteps, steps - q0);
        int prev = 0;
#pragma unroll
        for (int ks = 0; ks < kChunkSteps; ++ks) {
          if (ks < n) {
            // A[rows, 8 K rows]: lane (g, t) holds rows g, g + 8 at K rows
            // t, t + 4 (the m16n8k8 fragment of each warp's 16 rows).
            const float* a_k = sN + 8 * (step0 + q0 + ks) * TB;
            uint32_t ah[4], al[4];
            tc::split_tf32(a_k[a0], ah[0], al[0]);
            tc::split_tf32(a_k[a1], ah[1], al[1]);
            tc::split_tf32(a_k[a0 + 4 * TB], ah[2], al[2]);
            tc::split_tf32(a_k[a1 + 4 * TB], ah[3], al[3]);
            const uint32_t b_hi = ring + slot * kStageBytes;
            const uint64_t dh = hopper::desc_kmajor_sw32(b_hi);
            const uint64_t dl = hopper::desc_kmajor_sw32(b_hi + kStageBytes / 2);
            hopper::mbar_wait(full + 8 * slot, phase);
            hopper::wgmma_fence();
            mma(acc_lo, al, dh, ks > 0);
            mma(acc_lo, ah, dl, 1);
            mma(acc, ah, dh, ks > 0);
            hopper::wgmma_commit();
            if (ks > 0) {
              hopper::wgmma_wait<1>();
              release(prev);
            }
            prev = slot;
            if (++slot == a.stages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          hopper::fence_operand(acc[e]);
          hopper::fence_operand(acc_lo[e]);
        }
        release(prev);
        if constexpr (AUTO) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (j == 0 ? i0_first != n_i0 : (change >> j) & 1) {
              const int i0 = __shfl_sync(0xffffffffu, col, j);   // uniform
              load_densities<TB>(sN, i0 + 2 * t, r0, r1, nc);
              n_i0 = i0;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float c0 = acc[4 * j + 2 * h] + acc_lo[4 * j + 2 * h];
              const float c1 =
                  acc[4 * j + 2 * h + 1] + acc_lo[4 * j + 2 * h + 1];
              const float v = q0 == 0 ? 0.f : vp[2 * j + h];
              vp[2 * j + h] = fmaf(nc[2 * h + 1], c1, fmaf(nc[2 * h], c0, v));
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 64; ++e)
            run[e] = (q0 == 0 ? 0.f : run[e]) + (acc[e] + acc_lo[e]);
        }
      }

      // Epilogue of column tile ct.
      if constexpr (!AUTO) {
        // run[4 j + e] is row (e < 2 ? r0 : r1), column ct * 128 + 8 j +
        // 2 t + e % 2: statistic k = that column.
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = e < 2 ? r0 : r1;
            const int k = ct * kCols + 8 * j + 2 * t + (e & 1);
            if (row0 + b < a.batch && k < a.n_xi)
              out.xi[(size_t)(row0 + b) * out.stride +
                     (size_t)node * a.n_xi + k] =
                  run[4 * j + e] / (e < 2 ? tot0 : tot1);
          }
      } else {
        // The quad's shares of the n8 tiles j and j + 1, rows r0 and r1,
        // summed in three shuffles so that lane t ends with (tile j + t /
        // 2, row t % 2 ? r1 : r0): the quad sum (v0 + v1) + (v2 + v3) of
        // each, added to statistic col_k of that row.  Two tiles of one
        // statistic (an aligned pair) are added together first.
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const bool odd = t & 1, high = t & 2;
          int k = __shfl_sync(0xffffffffu, col, 16 + j + high);
          float x = (odd ? vp[2 * j + 1] : vp[2 * j]) +
                    __shfl_xor_sync(0xffffffffu,
                                    odd ? vp[2 * j] : vp[2 * j + 1], 1);
          float y = (odd ? vp[2 * j + 3] : vp[2 * j + 2]) +
                    __shfl_xor_sync(0xffffffffu,
                                    odd ? vp[2 * j + 2] : vp[2 * j + 3], 1);
          float v = (high ? y : x) +
                    __shfl_xor_sync(0xffffffffu, high ? x : y, 2);
          const float w = __shfl_xor_sync(0xffffffffu, v, 2);
          if ((paired >> (16 + j)) & 1) {
            v += w;
            k = high ? -1 : k;
          }
          if (k >= 0) sXi[(odd ? r1 : r0) * a.n_xi + k] += v;
        }
      }
    }
    if constexpr (!AUTO) continue;
    // The node's statistics of the warp's 16 rows, divided by (sum n)^2;
    // row r's total is held by lane 4 (r % 8), as tot0 (r < 8) or tot1.
    __syncwarp();
    const int n_items = 16 * a.n_xi;
    for (int base = 0; base < n_items; base += 32) {
      const int item = base + lane;
      const int r = min(item / a.n_xi, 15);
      const float ta = __shfl_sync(0xffffffffu, tot0, 4 * (r & 7));
      const float tb = __shfl_sync(0xffffffffu, tot1, 4 * (r & 7));
      if (item < n_items) {
        const float tot = r < 8 ? ta : tb;
        if (row0 + wrow + r < a.batch)
          out.xi[(size_t)(row0 + wrow + r) * out.stride +
                 (size_t)node * a.n_xi + (item - r * a.n_xi)] =
              xi_w[item] / (tot * tot);
        xi_w[item] = 0.f;
      }
    }
    __syncwarp();
  }
}

// A block of TB = 64 WGS rows: warpgroup 0 produces, warpgroups 1..WGS
// consume.
template <int WGS, int MODEL, bool AUTO>
__global__ void __launch_bounds__(128 * (WGS + 1), 1)
slab_tc_kernel(const Args args) {
  constexpr int TB = 64 * WGS, NT = 128 * (WGS + 1);
  extern __shared__ __align__(1024) unsigned char stc_smem[];
  const int n_slots = args.stages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stc_smem +
                                               (size_t)n_slots * kStageBytes);
  float* sN = reinterpret_cast<float*>(bars + 2 * n_slots);
  float* sXi = sN + (size_t)args.nb8 * TB;
  float* sPar = sXi + (size_t)TB * args.n_xi;
  const uint32_t ring = hopper::smem_addr(stc_smem);
  const uint32_t full = hopper::smem_addr(bars);
  const uint32_t empty = full + 8 * n_slots;
  if (ring & 255) __trap();   // the swizzle needs 256-byte aligned slots
  const int row0 = blockIdx.x * TB;

  param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  occupation_phase<TB, NT, MODEL, TB, true>(args.q, args.nb8, args.batch,
                                            row0, args.hod, sPar, sN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_slots; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, WGS * 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (WGS > 1) hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce(args, ring, full, empty);
  } else {
    if constexpr (WGS > 1) hopper::regs_inc<kConsumerRegs>();
    consume<TB, AUTO>(args, wg - 1, row0, ring, full, empty, sN, sXi);
  }
}

// Launch one instantiation over the batch in blocks of 64 WGS rows, each
// a cluster of one (cudaLaunchKernelEx with a cluster dimension).
template <int WGS, int MODEL, bool AUTO>
int launch(const Args& args, int device, void* stream) {
  auto kernel = slab_tc_kernel<WGS, MODEL, AUTO>;
  const size_t smem = smem_bytes(WGS, args.stages, args.nb8, args.n_xi);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (args.batch == 0) return 0;
  const int tb = 64 * WGS;
  const int blocks = (args.batch + tb - 1) / tb;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(128 * (WGS + 1));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return tc::setup_error(err);
  return (int)cudaGetLastError();
}

template <int WGS, bool AUTO>
int launch_model(const Args& args, int device, void* stream) {
  switch (args.hod.model) {
    case kZheng07:
      return launch<WGS, kZheng07, AUTO>(args, device, stream);
    case kAssembiasZheng07:
      return launch<WGS, kAssembiasZheng07, AUTO>(args, device, stream);
    default:
      return launch<WGS, kDensityIn, AUTO>(args, device, stream);
  }
}

template <int WGS>
int launch_mode(const Args& args, int device, void* stream) {
  return args.is_auto ? launch_model<WGS, true>(args, device, stream)
                      : launch_model<WGS, false>(args, device, stream);
}

}  // namespace stc

// The launch arguments of slab_kernel; false for what it does not take.
bool make_slab_args(const float* params, int batch, int model, int modulate,
                    double split, const float* logm, const float* res,
                    const float* sec, const float* w, int nb, int nc, int ng,
                    const float* b, long long node_stride,
                    const int* ct_step0, const int* ct_steps,
                    const int* ct_off, const int* col_k, const int* col_i0,
                    int n_ct, int n_nodes, int n_xi, int is_auto,
                    float* out_total, float* out_xi, SlabArgs* args) {
  *args = {};
  args->params = params;
  args->batch = batch;
  args->q.logm = logm;
  args->q.res = res;
  args->q.sec = sec;
  args->q.w = w;
  args->q.dens = model == kDensityIn ? params : nullptr;
  args->q.nb = nb;
  args->q.nc = nc;
  args->q.ng = ng;
  HalfTable& h = args->h;
  h.b = b;
  h.ct_step0 = ct_step0;
  h.ct_steps = ct_steps;
  h.ct_off = ct_off;
  h.col_k = col_k;
  h.col_i0 = col_i0;
  h.node_stride = (size_t)node_stride;
  h.n_nodes = n_nodes;
  h.n_xi = n_xi;
  h.n_ct = n_ct;
  h.is_auto = is_auto;
  h.nb = nb;
  h.nb8 = (nb + 7) / 8 * 8;
  args->out = {out_total, out_xi, (size_t)n_nodes * n_xi};
  return batch >= 0 && node_stride >= 0 && params != nullptr &&
         check_half_table(h, &args->q) &&
         make_hod(model, modulate, split, &args->hod);
}

}  // namespace

extern "C" {

// Launch the slab kernel (FP32) on `stream`.  `model`, `modulate` and
// `split` select the occupation (zheng07.cuh): `params` is the (batch,
// n_params) parameter matrix of codes 0 and 1, or code 2's (nb, batch)
// densities.
// `b` holds the n_nodes nodes' column tiles in the layout of
// ops/fused.py:slab_tc_table_constants, node m at b + m * node_stride.
// `stage_steps` is the ring stage in K steps of 8 rows
// (contract.cuh:fp32_stage_ok).  `out_xi` is (batch, n_nodes, n_xi).
// Returns the CUDA error code of the launch (0 on success); the kernel
// runs asynchronously.
int tabcorr_slab(const float* params, int batch, int model, int modulate,
                 double split, const float* logm,
                 const float* res, const float* sec, const float* w, int nb,
                 int nc, int ng, const float* b, long long node_stride,
                 const int* ct_step0, const int* ct_steps, const int* ct_off,
                 const int* col_k, const int* col_i0, int n_ct, int n_nodes,
                 int n_xi, int is_auto, int stage_steps, float* out_total,
                 float* out_xi, int device, void* stream) {
  SlabArgs args;
  if (!make_slab_args(params, batch, model, modulate, split, logm, res,
                      sec, w, nb, nc, ng, b, node_stride, ct_step0, ct_steps,
                      ct_off, col_k, col_i0, n_ct, n_nodes, n_xi, is_auto,
                      out_total, out_xi, &args) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  args.stage_steps = stage_steps;
  constexpr int TB = 64;
  const size_t smem =
      fp32_smem_floats(TB, stage_steps, args.h.nb8, n_xi) * sizeof(float);
  switch (args.hod.model) {
    case kZheng07:
      return launch_slab(slab_kernel<TB, kZheng07>, args, TB, 2 * TB, smem,
                         device, stream);
    case kAssembiasZheng07:
      return launch_slab(slab_kernel<TB, kAssembiasZheng07>, args, TB,
                         2 * TB, smem, device, stream);
    default:
      return launch_slab(slab_kernel<TB, kDensityIn>, args, TB, 2 * TB, smem,
                         device, stream);
  }
}

// Launch the slab_tc kernel (3xTF32 on wgmma) on `stream`: tabcorr_slab's
// function.  `b` holds the stages of ops/fused.py:
// slab_split_table_constants (node_steps per node, each 8 K rows of one
// 128-column tile, its TF32 hi and lo halves); ct_step0, ct_steps, col_k
// and col_i0 are the block-triangular half's column tables.  `wgs` (1 or
// 2) consumer warpgroups of 64 rows a block, `stages` (2..16) ring slots.
// Returns the CUDA error code of the launch (0 on success); the kernel
// runs asynchronously.
int tabcorr_slab_tc(const float* params, int batch, int model,
                    int modulate, double split, const float* logm,
                    const float* res, const float* sec, const float* w,
                    int nb, int nc, int ng, const float* b, int node_steps,
                    const int* ct_step0, const int* ct_steps,
                    const int* col_k, const int* col_i0, int n_ct,
                    int n_nodes, int n_xi, int is_auto, int wgs, int stages,
                    float* out_total, float* out_xi, int device,
                    void* stream) {
  stc::Args args = {};
  args.params = params;
  args.batch = batch;
  args.q = {logm, res, sec, w, model == kDensityIn ? params : nullptr, nb,
            nc, ng};
  args.b = b;
  args.ct_step0 = ct_step0;
  args.ct_steps = ct_steps;
  args.col_k = col_k;
  args.col_i0 = col_i0;
  args.node_steps = node_steps;
  args.n_nodes = n_nodes;
  args.n_xi = n_xi;
  args.n_ct = n_ct;
  args.is_auto = is_auto;
  args.nb = nb;
  args.nb8 = (nb + 7) / 8 * 8;
  args.stages = stages;
  args.out = {out_total, out_xi, (size_t)n_nodes * n_xi};
  if (batch < 0 || params == nullptr || b == nullptr || nb < 1 ||
      n_nodes < 1 || n_xi < 1 || n_ct < 1 || node_steps < 1 || nc < 0 ||
      nc > nb || ng < 1 || stages < 2 || stages > stc::kMaxStages ||
      !make_hod(model, modulate, split, &args.hod))
    return (int)cudaErrorInvalidValue;
  if (wgs == 2) return stc::launch_mode<2>(args, device, stream);
  if (wgs == 1) return stc::launch_mode<1>(args, device, stream);
  return (int)cudaErrorInvalidValue;
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
