// Bundle predictor kernel (B1) and contraction kernel (B3) for Hopper
// (sm_90a).
//
// bundle_kernel: zheng07 occupation quadrature (optionally with the
// Heaviside assembly-bias decoration), or for any other model the
// per-table densities computed beforehand by the occupation kernel
// (occupation.cu) or in tensor ops (model code 2, zheng07.cuh), and
// every table's wp / xi_ell contraction for a batch of parameter vectors,
// in one launch.  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_bundle_predictor.  Each table's
// contraction takes one of two routes, by its accuracy contract, as the
// Pallas kernel drops MXU passes for the rows of a 'scaled' table:
// * 'elementwise' tables, and cross tables under either contract, run in
//   FP32 on the CUDA cores (contract.cuh's contract_fp32);
// * 'scaled' auto tables run in 3xTF32 on the tensor cores (wgmma, B
//   split into TF32 halves once on the host and streamed by TMA; below),
//   the machinery of slab.cu's slab_tc for one node.
// A cross table's contraction is a matrix-vector product, n_xi * nb
// multiply-adds a row (a few per cent of an auto table's), so it stays on
// the CUDA cores under 'scaled' too, where it meets both contracts.  A
// launch with no 'scaled' auto table runs the FP32-only instantiation,
// the kernel as it was before the tensor-core route existed.
//
// contraction_kernel: the FP32 contraction for one table, with the
// per-bin densities n[b, i] read from device memory instead of computed
// (any occupation model, evaluated beforehand in tensor ops).  Replaces
// tabcorr_tpu/ops/fused.py:make_fused_contraction (wrapped there by
// make_fused_predictor).  It is its own launch.
//
// Both compute what the Pallas kernels compute, not their block structure.
//
// What bounds them on an H100.  Per parameter vector the contractions cost
// sum_tables n_xi * n_bins (n_bins + 1) / 2 multiply-adds over the
// symmetric half (19 * 1830 + 42 * 7260 = 339,690 for the wp + xi_ell
// bundle, 90% of them xi_ell's) against ~1,800 occupation evaluations
// (erfcf / exp10f / log1pf / expf, about 60-100 instructions each), and
// only 20-28 bytes of parameters (B3: 4 bytes per bin) in and ~250 bytes
// of results out.  The matrices (~1.5 MB for both tables in the half
// layout, xi_ell's 2.64 MB split) stay in the 50 MB L2.  On the FP32
// route the multiply-adds bound the kernel at the CUDA cores' rate.
//
// What the FP32 route does about it: a block owns 64 batch rows.  The
// per-bin densities of those rows sit in shared memory (B1 computes them
// there with the occupation of zheng07.cuh; B3 loads them) and are reused
// by every column of the contraction of contract.cuh, which multiplies
// only the block-triangular half of each symmetric matrix, streams it
// through a cp.async ring and reduces the quadratic form by the layout,
// without a barrier per column tile.  No fast math (see utils/build.py):
// the FP32 route meets the 'elementwise' contract, the stricter of the
// two.
//
// The tensor-core route (bundle_kernel<..., true>, namespace btc), slab_tc's
// two-consumer block for one node: a block owns 128 rows and is three
// warpgroups, one block an SM.
// * Every thread first computes every table's densities of the 128 rows
//   into shared memory (swizzled for the 'scaled' tables,
//   zheng07.cuh:swizzled_index), with 12 warps an SM, as many as the
//   FP32-only kernel's three blocks.
// * Then warpgroup 2 gives its registers to warpgroups 0 and 1 (setmaxnreg
//   24 / 240): ptxas allocates every region within the launch bound (168
//   registers a thread at 384 threads) unless setmaxnreg raises it, and at
//   168 it spills and serializes the consumers' wgmmas.  Two blocks of 256
//   threads an SM (128 registers a thread) spill 2.3 KB a thread.
// * Warpgroups 0 and 1 (consumers, 64 rows each) contract the FP32 tables
//   with contract_fp32 (one named barrier a warpgroup), consumer 0 through
//   the tensor-core ring's bytes, consumer 1 through a ring of its own;
//   then every 'scaled' table by three wgmma.mma_async m64n128k8 .tf32 a
//   k-step (A, the densities, from registers, split into hi / lo as
//   loaded; B from the ring), both consumers reading each stage.
// * One thread of warpgroup 2 streams every 'scaled' table's stages (8 K
//   rows of a 128-column tile, TF32 hi then lo, 8 KB) through a ring of 4
//   slots with TMA bulk copies, a full and an empty mbarrier a slot, once
//   both consumers are past the FP32 tables.
// The 'elementwise' tables keep the FP32-only kernel's bits: the same 64
// rows a contraction, ring stages and FMA chains, whatever threads run
// it.  The 'scaled' tables keep slab_tc's arithmetic bit for bit (its
// stage order, chunks of 4 k-steps into fresh accumulators, the fold of
// each chunk into the epilogue's sums; tests/test_torch_slab_wgmma.py
// emulates it), which meets the 'scaled' contract.  slab.cu's consumer is
// not shared: its node loop and its probe (scripts/torch_slab_probe.py,
// which patches its source) stay as they are.
// Measured (wp + xi_ell, 131,072 rows, H100 80GB HBM3 at 700 W): 2.98 ms a
// launch against the FP32-only kernel's 4.02.  Without the MMAs it takes
// 2.22 ms, without the occupation 2.12, without both 1.33 (the fold and
// epilogue, the FP32 tables): the consumers' fold runs while their tensor
// pipe is idle, as in slab_tc.  Tried and not kept: the FP32 tables on
// warpgroup 2 under the consumers' MMAs, the ring refilled by a consumer
// (at 168 registers: 3.71 ms); one consumer a block with two blocks an SM
// (12.9 ms, spilled); consumer 1 two stages behind consumer 0, and 6 or 8
// ring slots (no faster; 8 slots slowed the FP32 tables).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "contract.cuh"
#include "hopper.cuh"

namespace {

using namespace tabcorr;

constexpr int kMaxTables = 4;
constexpr int kPtrs = 13;        // per-table pointers passed from the host
constexpr int kDims = 7;         // per-table integers passed from the host

struct BundleTable {
  QuadArgs q;
  HalfTable h;           // tensor-core route: b holds the split stages
  TableOut out;
  int tc_steps;          // stages of the tensor-core route; 0: FP32 route
  int sn_off;            // tensor-core instantiation: its densities at sN +
                         // sn_off (floats)
};

struct BundleArgs {
  const float* params;  // (B, hod.n_params); null for model code 2
  int batch;
  HodArgs hod;
  int n_tables;
  int nb8_max;          // over the tables
  int nb8_sum;
  int nxi_max;
  int stage_steps;      // the FP32 ring stage, in K steps
  int tc_stages;        // the tensor-core tables' stages, summed
  BundleTable t[kMaxTables];
};

// ----------------------------------------------------------------------
// The tensor-core instantiation (see the note at the top).
namespace btc {
constexpr int kCols = 128;                      // columns of a tile
constexpr int kStageFloats = 2 * kCols * 8;     // one k-step: hi, lo
constexpr int kStageBytes = 4 * kStageFloats;   // 8192
// K steps of 8 rows per fresh accumulator, as in slab_tc.
constexpr int kChunkSteps = 4;
// Two consumer warpgroups of 64 rows and a producer warpgroup, one block
// an SM, as slab_tc's two-consumer block: 65,536 / 384 = 168 registers a
// thread at launch, while every thread computes the densities; then the
// producer gives its registers to the consumers (setmaxnreg 24 / 240,
// 128 x 24 + 256 x 240 <= 65,536), which run the FP32 tables and the
// MMAs (at 168 ptxas spills them and serializes their wgmmas).
constexpr int kConsumers = 2;
constexpr int kRows = 64 * kConsumers;          // rows of a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducer = 128 * kConsumers;     // the producer thread
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// Named barrier: the consumers are done with the FP32 tables and the
// producer warp may fill the ring (1 and 2 are the consumers' own).
constexpr int kRingFreeBar = kConsumers + 1;
// The ring: 4 slots of 8 KB, consumer 0's FP32 ring before the producer
// fills it (kStages * stage_steps * 8 * kCT floats, stage_steps <= 4),
// then the slots' full and empty barriers.
constexpr int kSlots = 4;
constexpr int kRingBytes = kSlots * kStageBytes;
static_assert(kStages * kFpStageSteps * 8 * kCT * 4 == kRingBytes,
              "the FP32 ring fits the tensor-core ring");

extern __shared__ __align__(1024) unsigned char btc_smem[];

__device__ __forceinline__ uint32_t slot_addr(int slot) {
  return hopper::smem_addr(btc_smem) + slot * kStageBytes;
}
__device__ __forceinline__ uint32_t full_bar(int slot) {
  return hopper::smem_addr(btc_smem) + kRingBytes + 8 * slot;
}
__device__ __forceinline__ uint32_t empty_bar(int slot) {
  return full_bar(kSlots + slot);
}

// A thread's position in the ring: slot and phase parity, carried from
// table to table.
struct Ring {
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void next() {
    if (++slot == kSlots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The producer: one thread streams every stage of every tensor-core table
// (table after table) through the ring, then waits until the consumers
// have released each slot for the last time.
__device__ void produce(const BundleArgs& args) {
  Ring r = {0, 0};
  for (int ti = 0; ti < args.n_tables; ++ti) {
    const BundleTable& t = args.t[ti];
    for (int s = 0; s < t.tc_steps; ++s) {
      hopper::mbar_wait(empty_bar(r.slot), r.phase ^ 1);
      hopper::mbar_arrive_expect_tx(full_bar(r.slot), kStageBytes);
      hopper::bulk_load(slot_addr(r.slot), t.h.b + (size_t)s * kStageFloats,
                        kStageBytes, full_bar(r.slot));
      r.next();
    }
  }
  for (int s = 0; s < min(kSlots, args.tc_stages); ++s) {
    hopper::mbar_wait(empty_bar(r.slot), r.phase ^ 1);
    r.next();
  }
}

// n[r0, i], n[r0, i + 1], n[r1, i], n[r1, i + 1] from sN.
__device__ __forceinline__ void load_densities(const float* sN, int i, int r0,
                                               int r1, float (&n)[4]) {
  n[0] = sN[swizzled_index<kRows>(i, r0)];
  n[1] = sN[swizzled_index<kRows>(i + 1, r0)];
  n[2] = sN[swizzled_index<kRows>(i, r1)];
  n[3] = sN[swizzled_index<kRows>(i + 1, r1)];
}

// xi and sum_i n_i of one 'scaled' auto table for the 64 rows of consumer
// warpgroup wg, from the densities n[b, i] of the block's rows at
// sN[swizzled_index<kRows>(i, b)]: slab_tc's consumer (slab.cu) for one
// node.  Per k-step three m64n128k8 products, lo*hi and hi*lo into one
// accumulator, hi*hi into another, both fresh each chunk of kChunkSteps
// k-steps; each chunk folded into the lane's share of sum_i n_i t[b, (k,
// i)] over its two bins of every n8 tile; at a column tile's end the
// quad's shares summed by shuffles into the row's statistics in sXi (row
// r at r * xi_stride), one lane per row and statistic; the warp's rows
// stored divided by (sum n)^2.
__device__ void contract_tc(const HalfTable& h, const TableOut& out,
                            int batch, int row0, int wg, Ring& ring,
                            const float* sN, float* sXi, int xi_stride) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // warp's rows
  const int r0 = wrow + g, r1 = r0 + 8;                      // this lane's

  // sum_i n_i of rows r0 and r1 in double: lane t takes bins t, t + 4, ...
  double s0 = 0.0, s1 = 0.0;
  for (int i = t; i < h.nb; i += 4) {
    s0 += sN[swizzled_index<kRows>(i, r0)];
    s1 += sN[swizzled_index<kRows>(i, r1)];
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float tot0 = static_cast<float>(s0);
  const float tot1 = static_cast<float>(s1);
  if (out.total != nullptr && t == 0) {
    if (row0 + r0 < batch) out.total[row0 + r0] = tot0;
    if (row0 + r1 < batch) out.total[row0 + r1] = tot1;
  }
  // The warp's 16 rows of statistics, each at a stride of the launch's
  // largest n_xi, so that no warp's rows of one table overlap another
  // warp's rows of the next.
  float* xi_w = sXi + (size_t)wrow * xi_stride;
  for (int item = lane; item < 16 * xi_stride; item += 32) xi_w[item] = 0.f;
  __syncwarp();

  // Release a slot once this warp's MMAs that read it are complete: one
  // arrival per warp on the slot's empty barrier.
  auto release = [&](int slot) {
    if (lane == 0) hopper::mbar_arrive(empty_bar(slot));
  };
  // The A fragments' offsets in sN at K rows t and t + 4 of any k-step.
  const int a0 = swizzled_index<kRows>(t, r0);
  const int a1 = swizzled_index<kRows>(t, r1);
  // The densities n[r0 | r1, i0 + 2t (+ 1)] of the bin tile i0 last read.
  int n_i0 = -1;
  float nc[4] = {0.f, 0.f, 0.f, 0.f};
  // acc (hi*hi) and acc_lo (the small products) of the current chunk:
  // element 4 j + e is row (e < 2 ? r0 : r1), column 8 j + 2 t + e % 2 of
  // the tile; vp[2 j + hh] the lane's share over its two bins of n8 tile j,
  // row hh ? r1 : r0.
  float acc[64], acc_lo[64], vp[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc_lo[e] = 0.f;
  for (int ct = 0; ct < h.n_ct; ++ct) {
    const int step0 = __ldg(h.ct_step0 + ct);
    const int steps = __ldg(h.ct_steps + ct);
    // The tile's column tables, one entry a lane (col_i0 of n8 tile l in
    // lane l, col_k in lane 16 + l), read by shuffles; bit j of `change`
    // (j = 1..15) is set where n8 tile j starts at another bin than tile
    // j - 1, bit 16 + j of `paired` (j even) where tiles j and j + 1 hold
    // one statistic.
    const int col = __ldg((threadIdx.x & 16 ? h.col_k : h.col_i0) +
                          ct * 16 + (threadIdx.x & 15));
    const int up = __shfl_up_sync(0xffffffffu, col, 1);
    const int down = __shfl_down_sync(0xffffffffu, col, 1);
    const unsigned change =
        __ballot_sync(0xffffffffu, lane > 0 && lane < 16 && col != up);
    const unsigned paired = __ballot_sync(
        0xffffffffu, lane >= 16 && !(lane & 1) && col == down);
    const int i0_first = __shfl_sync(0xffffffffu, col, 0);
    for (int q0 = 0; q0 < steps; q0 += kChunkSteps) {
      const int n = min(kChunkSteps, steps - q0);
      int prev = 0;
#pragma unroll
      for (int ks = 0; ks < kChunkSteps; ++ks) {
        if (ks < n) {
          // A[rows, 8 K rows]: lane (g, t) holds rows g, g + 8 at K rows
          // t, t + 4 (the m16n8k8 fragment of each warp's 16 rows).
          const float* a_k = sN + 8 * (step0 + q0 + ks) * kRows;
          uint32_t ah[4], al[4];
          tc::split_tf32(a_k[a0], ah[0], al[0]);
          tc::split_tf32(a_k[a1], ah[1], al[1]);
          tc::split_tf32(a_k[a0 + 4 * kRows], ah[2], al[2]);
          tc::split_tf32(a_k[a1 + 4 * kRows], ah[3], al[3]);
          const uint32_t b_hi = slot_addr(ring.slot);
          const uint64_t dh = hopper::desc_kmajor_sw32(b_hi);
          const uint64_t dl = hopper::desc_kmajor_sw32(b_hi + kStageBytes / 2);
          hopper::mbar_wait(full_bar(ring.slot), ring.phase);
          hopper::wgmma_fence();
          hopper::wgmma_tf32_n128(acc_lo, al, dh, ks > 0);
          hopper::wgmma_tf32_n128(acc_lo, ah, dl, 1);
          hopper::wgmma_tf32_n128(acc, ah, dh, ks > 0);
          hopper::wgmma_commit();
          if (ks > 0) {
            hopper::wgmma_wait<1>();
            release(prev);
          }
          prev = ring.slot;
          ring.next();
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        hopper::fence_operand(acc[e]);
        hopper::fence_operand(acc_lo[e]);
      }
      release(prev);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j == 0 ? i0_first != n_i0 : (change >> j) & 1) {
          const int i0 = __shfl_sync(0xffffffffu, col, j);   // uniform
          load_densities(sN, i0 + 2 * t, r0, r1, nc);
          n_i0 = i0;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float c0 = acc[4 * j + 2 * hh] + acc_lo[4 * j + 2 * hh];
          const float c1 =
              acc[4 * j + 2 * hh + 1] + acc_lo[4 * j + 2 * hh + 1];
          const float v = q0 == 0 ? 0.f : vp[2 * j + hh];
          vp[2 * j + hh] = fmaf(nc[2 * hh + 1], c1, fmaf(nc[2 * hh], c0, v));
        }
      }
    }
    // Epilogue of column tile ct: the quad's shares of the n8 tiles j and
    // j + 1, rows r0 and r1, summed in three shuffles so that lane t ends
    // with (tile j + t / 2, row t % 2 ? r1 : r0): the quad sum (v0 + v1) +
    // (v2 + v3) of each, added to statistic col_k of that row.  Two tiles
    // of one statistic (an aligned pair) are added together first.
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const bool odd = t & 1, high = t & 2;
      int k = __shfl_sync(0xffffffffu, col, 16 + j + high);
      const float x = (odd ? vp[2 * j + 1] : vp[2 * j]) +
                      __shfl_xor_sync(0xffffffffu,
                                      odd ? vp[2 * j] : vp[2 * j + 1], 1);
      const float y = (odd ? vp[2 * j + 3] : vp[2 * j + 2]) +
                      __shfl_xor_sync(0xffffffffu,
                                      odd ? vp[2 * j + 2] : vp[2 * j + 3], 1);
      float v = (high ? y : x) + __shfl_xor_sync(0xffffffffu, high ? x : y, 2);
      const float w = __shfl_xor_sync(0xffffffffu, v, 2);
      if ((paired >> (16 + j)) & 1) {
        v += w;
        k = high ? -1 : k;
      }
      if (k >= 0) sXi[(odd ? r1 : r0) * xi_stride + k] += v;
    }
  }
  // The statistics of the warp's 16 rows, divided by (sum n)^2; row r's
  // total is held by lane 4 (r % 8), as tot0 (r < 8) or tot1.
  __syncwarp();
  const int n_items = 16 * h.n_xi;
  for (int base = 0; base < n_items; base += 32) {
    const int item = base + lane;
    const int r = min(item / h.n_xi, 15);
    const int k = item - r * h.n_xi;
    const float ta = __shfl_sync(0xffffffffu, tot0, 4 * (r & 7));
    const float tb = __shfl_sync(0xffffffffu, tot1, 4 * (r & 7));
    if (item < n_items && row0 + wrow + r < batch) {
      const float tot = r < 8 ? ta : tb;
      out.xi[(size_t)(row0 + wrow + r) * out.stride + k] =
          xi_w[r * xi_stride + k] / (tot * tot);
    }
  }
}

// Consumer warpgroup wg = BAR - 1, 64 rows of the block, with the
// producer's registers: the FP32 tables through its own ring (consumer 0's
// is the tensor-core ring, not yet filled), then the tensor-core tables.
template <int BAR>
__device__ __forceinline__ void consume(const BundleArgs& args, int row0,
                                        float* sRing, const float* sN,
                                        float* sXi, float* sTot) {
  constexpr int wg = BAR - 1;
  hopper::regs_inc<kConsumerRegs>();
  for (int ti = 0; ti < args.n_tables; ++ti) {
    const BundleTable& t = args.t[ti];
    if (t.tc_steps == 0)
      contract_fp32<64, BAR, kRows>(
          t.h, t.out, args.batch, row0 + 64 * wg, args.stage_steps,
          sN + t.sn_off + 64 * wg, sRing,
          sXi + (size_t)wg * 64 * args.nxi_max, sTot + 64 * wg);
  }
  // Order this thread's accesses of its FP32 ring before the TMA writes
  // into it.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.arrive %0, %1;" ::"n"(kRingFreeBar),
               "n"(128 * kConsumers + 32) : "memory");
  Ring ring = {0, 0};
  for (int ti = 0; ti < args.n_tables; ++ti) {
    const BundleTable& t = args.t[ti];
    if (t.tc_steps != 0)
      contract_tc(t.h, t.out, args.batch, row0, wg, ring, sN + t.sn_off,
                  sXi, args.nxi_max);
  }
}

// The tensor-core instantiation's block.  Shared memory: the ring (kSlots
// slots of kStageBytes, 1024-byte aligned; consumer 0's FP32 ring first)
// and its full and empty barriers; consumer 1's FP32 ring (stage_steps *
// 8 KB); sN (every table's densities [nb8][kRows] at its sn_off, swizzled
// for the tensor-core tables); sXi [kRows][nxi_max]; sPar
// [kParTerms][kRows]; sTot [kRows].
template <int MODEL>
__device__ __forceinline__ void bundle_block(const BundleArgs& args) {
  float* sRing1 = reinterpret_cast<float*>(btc_smem + kRingBytes +
                                           16 * kSlots);
  float* sN = sRing1 + (size_t)args.stage_steps * kStageBytes / 4;
  float* sXi = sN + (size_t)args.nb8_sum * kRows;
  float* sPar = sXi + (size_t)kRows * args.nxi_max;
  float* sTot = sPar + kParTerms * kRows;
  if (slot_addr(0) & 255) __trap();   // the swizzle needs aligned slots
  const int row0 = blockIdx.x * kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 4 * kConsumers);
    }
    hopper::fence_barrier_init();
  }
  param_terms<kRows, MODEL>(args.params, args.batch, row0, args.hod, sPar);
  __syncthreads();
  // Every table's densities, by every thread.
  for (int ti = 0; ti < args.n_tables; ++ti) {
    const BundleTable& t = args.t[ti];
    if (t.tc_steps != 0)
      occupation_phase<kRows, kThreads, MODEL, kRows, true>(
          t.q, t.h.nb8, args.batch, row0, args.hod, sPar, sN + t.sn_off);
    else
      occupation_phase<kRows, kThreads, MODEL>(
          t.q, t.h.nb8, args.batch, row0, args.hod, sPar, sN + t.sn_off);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x < kProducer + 32) {
      // Once consumer 0 is done with its FP32 ring.
      asm volatile("bar.sync %0, %1;" ::"n"(kRingFreeBar),
                   "n"(128 * kConsumers + 32) : "memory");
      if (threadIdx.x == kProducer) produce(args);
    }
  } else if (wg == 0) {
    consume<1>(args, row0, reinterpret_cast<float*>(btc_smem), sN, sXi,
               sTot);
  } else {
    consume<2>(args, row0, sRing1, sN, sXi, sTot);
  }
}

// Dynamic shared memory of the tensor-core instantiation (bundle_block).
inline size_t smem_bytes(int stage_steps, int nb8_sum, int nxi_max) {
  return kRingBytes + 16 * kSlots + (size_t)stage_steps * kStageBytes +
         4 * (size_t)kRows * (nb8_sum + nxi_max + kParTerms + 1);
}

}  // namespace btc

// TC false, every table on the FP32 route: a block of 2 TB threads.
// Shared-memory layout (floats), per block: sN [nb8_max][TB], the ring,
// sXi [TB][nxi_max], sPar [kParTerms][TB], sTot [TB]
// (contract.cuh:fp32_smem_floats).  TC true: btc::bundle_block.
template <int TB, int MODEL, bool TC>
__global__ void __launch_bounds__(TC ? btc::kThreads : 2 * TB,
                                  TC ? 1 : kMinBlocks)
bundle_kernel(const BundleArgs args) {
  if constexpr (TC) {
    btc::bundle_block<MODEL>(args);
  } else {
    extern __shared__ float4 smem4[];
    float* sN = reinterpret_cast<float*>(smem4);
    float* sRing = sN + (size_t)args.nb8_max * TB;
    float* sXi = sRing + kStages * args.stage_steps * 8 * kCT;
    float* sPar = sXi + (size_t)TB * args.nxi_max;
    float* sTot = sPar + kParTerms * TB;
    const int row0 = blockIdx.x * TB;

    // Per-row parameter terms, shared by every table.
    param_terms<TB, MODEL>(args.params, args.batch, row0, args.hod, sPar);
    __syncthreads();

    for (int ti = 0; ti < args.n_tables; ++ti) {
      const BundleTable& t = args.t[ti];
      occupation_phase<TB, 2 * TB, MODEL>(t.q, t.h.nb8, args.batch, row0,
                                          args.hod, sPar, sN);
      __syncthreads();
      contract_fp32<TB>(t.h, t.out, args.batch, row0, args.stage_steps, sN,
                        sRing, sXi, sTot);
    }
  }
}

template <int TB>
__global__ void __launch_bounds__(2 * TB, kMinBlocks)
contraction_kernel(const float* ngal, int batch, int stage_steps,
                   const HalfTable h, const TableOut out) {
  extern __shared__ float4 smem4[];
  float* sN = reinterpret_cast<float*>(smem4);
  float* sRing = sN + (size_t)h.nb8 * TB;
  float* sXi = sRing + kStages * stage_steps * 8 * kCT;
  float* sTot = sXi + (size_t)TB * h.n_xi + kParTerms * TB;
  const int row0 = blockIdx.x * TB;
  // Bin-fastest reads of the (B, nb) rows; padded bins and rows get 0.
  for (int item = threadIdx.x; item < TB * h.nb8; item += 2 * TB) {
    const int b = item / h.nb8;
    const int i = item % h.nb8;
    sN[i * TB + b] = (i < h.nb && row0 + b < batch)
                         ? __ldg(ngal + (size_t)(row0 + b) * h.nb + i)
                         : 0.f;
  }
  __syncthreads();
  contract_fp32<TB>(h, out, batch, row0, stage_steps, sN, sRing, sXi,
                        sTot);
}

// Set the kernel's dynamic shared memory and launch it over `batch` rows
// in blocks of `tb`.
template <class Kernel, class... Args>
int launch_rows(Kernel kernel, int batch, int tb, int threads, size_t smem,
                int device, void* stream, const Args&... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return tc::setup_error(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return tc::setup_error(err);
  if (batch == 0) return 0;
  kernel<<<(batch + tb - 1) / tb, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// The launch arguments from the host's per-table lists: `ptrs` holds
// (logm, res, sec, w, b, ct_step0, ct_steps, ct_off, col_k, col_i0,
// out_total, out_xi, dens) and `dims` (nb, nc, ng, n_xi, n_ct, is_auto,
// tc_steps) per table; `dens` is the table's (nb, B) densities for model
// code 2, else null, and `params` null for code 2.  tc_steps > 0 puts an
// auto table on the tensor-core route: `b` then holds its tc_steps split
// stages (ops/fused.py:slab_split_table_constants with one node) and
// `ct_off` is unread.  False for what the kernel does not take.
bool make_bundle_args(const float* params, int batch, int model,
                      int modulate, double split, int n_tables,
                      void* const* ptrs, const int* dims, BundleArgs* args) {
  if (n_tables < 1 || n_tables > kMaxTables || batch < 0) return false;
  *args = {};
  args->params = params;
  args->batch = batch;
  if (!make_hod(model, modulate, split, &args->hod) ||
      (args->hod.model == kDensityIn) != (params == nullptr))
    return false;
  args->n_tables = n_tables;
  for (int ti = 0; ti < n_tables; ++ti) {
    void* const* p = ptrs + ti * kPtrs;
    const int* d = dims + ti * kDims;
    BundleTable& t = args->t[ti];
    t.q.logm = static_cast<const float*>(p[0]);
    t.q.res = static_cast<const float*>(p[1]);
    t.q.sec = static_cast<const float*>(p[2]);
    t.q.w = static_cast<const float*>(p[3]);
    t.h.b = static_cast<const float*>(p[4]);
    t.h.ct_step0 = static_cast<const int*>(p[5]);
    t.h.ct_steps = static_cast<const int*>(p[6]);
    t.h.ct_off = static_cast<const int*>(p[7]);
    t.h.col_k = static_cast<const int*>(p[8]);
    t.h.col_i0 = static_cast<const int*>(p[9]);
    t.out.total = static_cast<float*>(p[10]);
    t.out.xi = static_cast<float*>(p[11]);
    t.q.dens = static_cast<const float*>(p[12]);
    if ((args->hod.model == kDensityIn) != (t.q.dens != nullptr))
      return false;
    t.q.nb = t.h.nb = d[0];
    t.q.nc = d[1];
    t.q.ng = d[2];
    t.h.n_xi = d[3];
    t.out.stride = d[3];
    t.h.n_ct = d[4];
    t.h.is_auto = d[5];
    t.tc_steps = d[6];
    t.h.n_nodes = 1;
    t.h.nb8 = (t.h.nb + 7) / 8 * 8;
    if (!check_half_table(t.h, &t.q) || t.tc_steps < 0 ||
        (t.tc_steps > 0 && !t.h.is_auto))
      return false;
    t.sn_off = args->nb8_sum * btc::kRows;
    args->nb8_sum += t.h.nb8;
    args->tc_stages += t.tc_steps;
    args->nb8_max = std::max(args->nb8_max, t.h.nb8);
    args->nxi_max = std::max(args->nxi_max, t.h.n_xi);
  }
  return true;
}

}  // namespace

extern "C" {

// Launch the bundle kernel on `stream`.  `model`, `modulate` and `split`
// select the occupation (zheng07.cuh; code 2 reads each table's densities
// and no `params`); `ptrs` and `dims` hold the tables
// (make_bundle_args), their matrices in the layout of
// ops/fused.py:slab_tc_table_constants with one node, or split
// (slab_split_table_constants) for the tensor-core route.  `stage_steps`
// is the FP32 ring stage in K steps of 8 rows (contract.cuh:
// fp32_stage_ok); with a tensor-core table the ring's bytes hold as many
// stages of 8 KB.  Returns the CUDA error code of the launch (0 on
// success); the kernel runs asynchronously.
int tabcorr_bundle(const float* params, int batch, int model, int modulate,
                   double split, int n_tables, void* const* ptrs,
                   const int* dims, int stage_steps, int device,
                   void* stream) {
  BundleArgs args;
  if (!make_bundle_args(params, batch, model, modulate, split, n_tables,
                        ptrs, dims, &args) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  args.stage_steps = stage_steps;
  constexpr int TB = 64;
  if (args.tc_stages > 0) {
    constexpr int R = btc::kRows, NT = btc::kThreads;
    const size_t smem = btc::smem_bytes(stage_steps, args.nb8_sum,
                                        args.nxi_max);
    switch (args.hod.model) {
      case kZheng07:
        return launch_rows(bundle_kernel<TB, kZheng07, true>, batch, R, NT,
                           smem, device, stream, args);
      case kAssembiasZheng07:
        return launch_rows(bundle_kernel<TB, kAssembiasZheng07, true>, batch,
                           R, NT, smem, device, stream, args);
      default:
        return launch_rows(bundle_kernel<TB, kDensityIn, true>, batch, R, NT,
                           smem, device, stream, args);
    }
  }
  const size_t smem = fp32_smem_floats(TB, stage_steps, args.nb8_max,
                                       args.nxi_max) * sizeof(float);
  switch (args.hod.model) {
    case kZheng07:
      return launch_rows(bundle_kernel<TB, kZheng07, false>, batch, TB,
                         2 * TB, smem, device, stream, args);
    case kAssembiasZheng07:
      return launch_rows(bundle_kernel<TB, kAssembiasZheng07, false>, batch,
                         TB, 2 * TB, smem, device, stream, args);
    default:
      return launch_rows(bundle_kernel<TB, kDensityIn, false>, batch, TB,
                         2 * TB, smem, device, stream, args);
  }
}

// Launch the contraction kernel on `stream` for one table: `ngal` is the
// contiguous (batch, nb) float32 density, the matrix in the bundle's
// layout.  Returns the CUDA error code of the launch.
int tabcorr_contraction(const float* ngal, int batch, const float* b,
                        const int* ct_step0, const int* ct_steps,
                        const int* ct_off, const int* col_k,
                        const int* col_i0, int n_ct, int nb, int n_xi,
                        int is_auto, int stage_steps, float* out_total,
                        float* out_xi, int device, void* stream) {
  HalfTable h = {};
  h.b = b;
  h.ct_step0 = ct_step0;
  h.ct_steps = ct_steps;
  h.ct_off = ct_off;
  h.col_k = col_k;
  h.col_i0 = col_i0;
  h.n_nodes = 1;
  h.n_xi = n_xi;
  h.n_ct = n_ct;
  h.is_auto = is_auto;
  h.nb = nb;
  h.nb8 = (nb + 7) / 8 * 8;
  const TableOut out = {out_total, out_xi, (size_t)n_xi};
  if (batch < 0 || !check_half_table(h, nullptr) ||
      !fp32_stage_ok(stage_steps))
    return (int)cudaErrorInvalidValue;
  constexpr int TB = 64;
  const size_t smem =
      fp32_smem_floats(TB, stage_steps, h.nb8, n_xi) * sizeof(float);
  return launch_rows(contraction_kernel<TB>, batch, TB, 2 * TB, smem, device,
                     stream, ngal, batch, stage_steps, h, out);
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
