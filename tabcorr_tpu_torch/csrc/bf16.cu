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
// wgmma.mma_async m64nNk16 with float32 accumulators.  The auto fold
// sum_i t[k, i] n_i runs on the float32 accumulators (t is never rounded
// to bfloat16); sum_i n_i and the division are float32; only total and xi
// are rounded to bfloat16 (to nearest), the route's output type.  The
// matrix comes as column tiles built once on the host
// (ops/fused.py:bf16_table_constants), each tile's bins K-major in the
// 128-byte swizzle (a last 32-bin chunk in the 64-byte one), exactly as
// the wgmma descriptors read them, so that one TMA bulk copy moves a tile
// into a ring slot.  Two kernels, by the padded bins kp:
//
// * Registers (kp <= 160, a multiple of 32: wp, xi_ell and Delta Sigma
//   tables, the 64-node and the wide grids).  Auto mode does 2 kp
//   tensor-core operations per product column and row against 2 kp bytes
//   read, hundreds per byte, above the card's ~295; beside the tensor
//   cores it is bound by the fold, one FMA and one bfloat16 unpack per
//   product column on the CUDA cores, which weighs most at 64 bins, and
//   by the matrix streamed from L2 to every block.  Cross mode is bound
//   by its bytes.  A block holds a producer warpgroup (one thread streams
//   column tiles through an mbarrier ring with TMA bulk copies; setmaxnreg
//   gives its registers to the consumers) and two consumer warpgroups of
//   128 rows each (two m64 tiles), 256 rows a block, so that every tile
//   copied serves 256 rows.  A consumer loads its rows' A fragments (the
//   m16n8k16 fragment of each warp's 16 rows) once for the whole K from
//   device memory, with no branch, and keeps them in registers; they are
//   also the fold's densities (column i of each statistic is bin i) and
//   give sum_i n_i (a sum and a quad shuffle), so nothing is re-read.  A
//   tile covers whole statistics (auto: 128 / kp of them up to 64 bins,
//   one at 96, half a statistic at 128 and 160 bins, N = 64 or 80, so
//   that two accumulator sets and both m64 tiles' fragments fit in 240
//   registers; cross: 64 statistics).  The consumer issues the next job's
//   wgmmas (the other accumulator set) before it folds the current one
//   (wgmma.wait_group 1), so the fold overlaps the tensor cores; each
//   lane ends its quad's sums of its own row and statistic (3 shuffles
//   for 4 sums) and multiplies by the row's 1 / (sum n)^2.  Accumulators
//   are only read on the warpgroup's common path (predicated stores):
//   ptxas serializes the wgmmas of a kernel that reads them on a
//   divergent one.  Results are staged in shared memory in windows of 64
//   statistics (or the whole row) and written as whole rows with 16-byte
//   stores.  Blocks are persistent and walk the column tiles in the same
//   order, so that they share the matrix's L2 lines.
// * Streamed (kp > 160, a multiple of 64: the 1104-bin 'efficient' Delta
//   Sigma grid, 52 statistics).  A cross table is bound by reading the
//   densities once (~52 operations a byte).  A producer warp streams, per
//   64-bin chunk of K, the block's 128 density rows through a 2-D tensor
//   map (TMA, 128-byte swizzle; rows past the batch and bins past nb
//   arrive as zeros) and the matrix's matching chunk, into one ring slot;
//   two consumer warpgroups run wgmma with both operands from shared
//   memory, accumulating over the chunks.  Column 0 of the matrix holds
//   ones, so the accumulators carry sum_j n_j (the statistics follow it;
//   52 + 1 columns fill N = 64 for free).  Two blocks share an SM so that
//   HBM stays busy.  Auto tables this wide (no main path has one) run the
//   same loop over column tiles of 64 (a first tile holds the ones
//   column) and fold each statistic's tiles with densities read from
//   device memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tabcorr {
namespace bf16 {

constexpr int kConsumers = 2;     // consumer warpgroups a block
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
// Registers a thread of the producer and of a consumer warpgroup keeps
// after setmaxnreg (registers kernel: 128 x 24 + 256 x 240 <= 65,536).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

struct Args {
  const __nv_bfloat16* ngal;     // (batch, nb)
  const __nv_bfloat16* image;    // (n_tiles, cols * kp): the column tiles
  __nv_bfloat16* total;          // (batch,)
  __nv_bfloat16* xi;             // (batch, n_xi)
  int batch, nb, kp, n_xi;
  int n_tiles;                   // column tiles
  int stages;                    // ring slots
  int win;                       // statistics a staging row holds
  int row_tiles;                 // row tiles of the batch
};

__device__ __forceinline__ float lo_bf16(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The quad sums of V values a lane holds, transposed so that each lane
// ends with its own: lane t gets those of values 4 i + t (V >= 4; i < V /
// 4) in r[i], or of value t & 1 (V = 2) in r[0].  Values of the lane's
// odd partner are exchanged first (V / 2 shuffles), then those of the
// lane two away (V / 4, or 1): 3 shuffles for 4 values where separate
// quad sums take 8.
template <int V>
__device__ __forceinline__ void quad_reduce(const float (&v)[V],
                                            float (&r)[V >= 4 ? V / 4 : 1],
                                            int t) {
  const bool b0 = t & 1, b1 = t & 2;
  float h[V / 2];
#pragma unroll
  for (int i = 0; i < V / 2; ++i)
    h[i] = (b0 ? v[2 * i + 1] : v[2 * i]) +
           __shfl_xor_sync(0xffffffffu, b0 ? v[2 * i] : v[2 * i + 1], 1);
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      r[i] = (b1 ? h[2 * i + 1] : h[2 * i]) +
             __shfl_xor_sync(0xffffffffu, b1 ? h[2 * i] : h[2 * i + 1], 2);
  } else {
    r[0] = h[0] + __shfl_xor_sync(0xffffffffu, h[0], 2);
  }
}

// *p = v where `pred`, as one predicated store: no branch, so that the
// accumulators read for v are read on the warpgroup's common path (a read
// on a divergent one makes ptxas serialize the wgmmas).
__device__ __forceinline__ void store_if(__nv_bfloat16* p, float v,
                                         bool pred) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.shared.b16 [%0], %1;\n}"
      ::"r"(hopper::smem_addr(p)), "h"(*reinterpret_cast<const unsigned short*>(&b)),
      "r"((int)pred)
      : "memory");
}

// Dynamic shared memory: the ring from the first 1024-byte boundary
// (`slot_bytes`, a multiple of 1024, a slot), its full and empty
// barriers, then each consumer warpgroup's two staging buffers.
struct Layout {
  uint32_t ring, full, empty;
  __nv_bfloat16* staging;
};

__device__ __forceinline__ Layout layout(unsigned char* raw, int stages,
                                         int slot_bytes) {
  const uint32_t base = hopper::smem_addr(raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  Layout l;
  l.ring = base + pad;
  l.full = l.ring + stages * slot_bytes;
  l.empty = l.full + 8 * stages;
  l.staging = reinterpret_cast<__nv_bfloat16*>(
      raw + pad + (size_t)stages * slot_bytes + 16 * stages);
  return l;
}

__host__ __forceinline__ size_t smem_bytes(int stages, int slot_bytes,
                                           int rows, int win) {
  return 1024 + (size_t)stages * (slot_bytes + 16) +
         (size_t)2 * kConsumers * rows * win * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void init_barriers(const Layout& l, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(l.full + 8 * s, 1);
      hopper::mbar_init(l.empty + 8 * s, kConsumers * 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// Release a slot once this warp's MMAs that read it are complete: one
// arrival per consumer warp.
__device__ __forceinline__ void release(const Layout& l, int slot) {
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(l.empty + 8 * slot);
}

__device__ __forceinline__ void advance(int& slot, uint32_t& phase,
                                        int stages) {
  if (++slot == stages) {
    slot = 0;
    phase ^= 1;
  }
}

// Write statistics [k0, k0 + kw) of `rows` rows (from row0) out of a
// staging buffer (row stride a.win) to xi, by the warpgroup's 128
// threads (`tid`): whole rows as one contiguous run of 16-byte stores
// (a.win == n_xi; row0 is a multiple of 64, so the run is aligned),
// aligned row segments as 16-byte stores, anything else element by
// element (consecutive threads, consecutive elements).
__device__ void flush(const Args& a, const __nv_bfloat16* buf, int row0,
                      int rows, int k0, int kw, int tid) {
  if (rows <= 0 || kw <= 0) return;
  __nv_bfloat16* dst = a.xi + (size_t)row0 * a.n_xi + k0;
  if (kw == a.n_xi) {
    const int n = rows * kw, n16 = n >> 3;
    for (int u = tid; u < n16; u += 128)
      reinterpret_cast<uint4*>(dst)[u] =
          reinterpret_cast<const uint4*>(buf)[u];
    for (int e = 8 * n16 + tid; e < n; e += 128) dst[e] = buf[e];
  } else if (((a.n_xi | kw | k0 | a.win) & 7) == 0) {
    const int q = kw >> 3;
    for (int u = tid; u < rows * q; u += 128) {
      const int r = u / q, c = u - r * q;
      reinterpret_cast<uint4*>(dst + (size_t)r * a.n_xi)[c] =
          reinterpret_cast<const uint4*>(buf + (size_t)r * a.win)[c];
    }
  } else {
    for (int e = tid; e < rows * kw; e += 128) {
      const int r = e / kw, c = e - r * kw;
      dst[(size_t)r * a.n_xi + c] = buf[(size_t)r * a.win + c];
    }
  }
}

// ======================================================================
// The registers kernel (kp <= 160)
// ======================================================================
namespace reg {

template <int KP, bool AUTO>
struct Cfg {
  static constexpr int KS = KP / 16;                       // k16 steps
  static constexpr int H = AUTO && KP >= 128 ? 2 : 1;      // tiles a stat.
  static constexpr int S = !AUTO ? 64 : H == 2 ? 1 : (KP <= 64 ? 128 / KP
                                                                : 1);
  static constexpr int N = !AUTO ? 64 : H == 2 ? KP / 2 : S * KP;
  static constexpr int MT = 2;                             // m64 tiles
  static constexpr int ROWS = 64 * MT;                     // a warpgroup's
  static constexpr int SLOT = (N * KP * 2 + 1023) / 1024 * 1024;
};

// Descriptor of k-step `ks` of the tile in the slot at `slot`: 64-bin
// chunks in the 128-byte swizzle (N rows of 128 bytes each), a last
// 32-bin chunk in the 64-byte one.
template <int N, int KP>
__device__ __forceinline__ uint64_t b_desc(uint32_t slot, int ks) {
  constexpr int kFull = KP / 64;
  return ks < 4 * kFull
             ? hopper::desc_kmajor(slot + (ks / 4) * N * 128 + (ks % 4) * 32,
                                   128)
             : hopper::desc_kmajor(
                   slot + kFull * N * 128 + (ks - 4 * kFull) * 32, 64);
}

// n[row, bin], n[row, bin + 1] as a bfloat16 pair (bin even); zero past
// the batch and past nb.  Loads from a clamped address and a select, no
// branch: the fragments are wgmma operands (see store_if).
__device__ __forceinline__ uint32_t load_pair(const Args& a, int row,
                                              int bin) {
  const bool ok = row < a.batch && bin < a.nb;
  const __nv_bfloat16* p = a.ngal + (ok ? (size_t)row * a.nb + bin : 0);
  uint32_t v;
  if ((a.nb & 1) == 0) {
    v = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    const bool two = bin + 1 < a.nb;
    const uint32_t lo = __ldg(reinterpret_cast<const unsigned short*>(p));
    const uint32_t hi =
        __ldg(reinterpret_cast<const unsigned short*>(p) + (two ? 1 : 0));
    v = lo | (two ? hi << 16 : 0u);
  }
  return ok ? v : 0u;
}

// Issue one job: d = A (the m64 tile's fragments) times the tile in the
// slot at `slot`, all KS k-steps, one commit group.
template <int KP, bool AUTO>
__device__ __forceinline__ void issue(float (&d)[Cfg<KP, AUTO>::N / 2],
                                      const uint32_t (&a)[KP / 16][4],
                                      uint32_t slot) {
  constexpr int N = Cfg<KP, AUTO>::N;
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KP / 16; ++ks)
    hopper::wgmma_bf16_rs<N>(d, a[ks], b_desc<N, KP>(slot, ks), ks > 0);
  hopper::wgmma_commit();
}

// The lane's share of sum_i t[row, k, i] n[row, i] over the n8 tiles
// [j0, j0 + n8) of the accumulator, whose bins start at n8 tile b0 of the
// statistic (j0, b0 constants once unrolled): rows g (p0) and g + 8 (p1),
// even and odd n8 tiles in two chains each, added at the end.
template <int NH, int n8, int KS>
__device__ __forceinline__ void fold(const float (&d)[NH],
                                     const uint32_t (&a)[KS][4], int j0,
                                     int b0, float& p0, float& p1) {
  float e0 = 0.f, e1 = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < n8; ++jj) {
    const int j = j0 + jj, b = b0 + jj;
    const uint32_t x0 = a[b / 2][(b & 1) * 2], x1 = a[b / 2][(b & 1) * 2 + 1];
    if (jj & 1) {
      o0 = fmaf(d[4 * j + 1], hi_bf16(x0), fmaf(d[4 * j], lo_bf16(x0), o0));
      o1 = fmaf(d[4 * j + 3], hi_bf16(x1), fmaf(d[4 * j + 2], lo_bf16(x1), o1));
    } else {
      e0 = fmaf(d[4 * j + 1], hi_bf16(x0), fmaf(d[4 * j], lo_bf16(x0), e0));
      e1 = fmaf(d[4 * j + 3], hi_bf16(x1), fmaf(d[4 * j + 2], lo_bf16(x1), e1));
    }
  }
  p0 = e0 + o0;
  p1 = e1 + o1;
}

// Issue the job at position p of a round (set p & 1, m64 tile p % MT,
// `a_m` its fragments) on its tile's slot: the ring's next slot where it
// starts a tile (p % MT == 0), else `prev_slot`, the slot of the job
// before it.
template <int KP, bool AUTO>
__device__ __forceinline__ void issue_job(
    const Args& a, const Layout& l, int p,
    float (&d)[Cfg<KP, AUTO>::N / 2], const uint32_t (&a_m)[KP / 16][4],
    int& my_slot, int prev_slot, int& slot, uint32_t& phase) {
  if (p % Cfg<KP, AUTO>::MT == 0) {
    my_slot = slot;
    hopper::mbar_wait(l.full + 8 * slot, phase);
    advance(slot, phase, a.stages);
  } else {
    my_slot = prev_slot;
  }
  issue<KP, AUTO>(d, a_m, l.ring + my_slot * Cfg<KP, AUTO>::SLOT);
}

template <int KP, bool AUTO>
__device__ void consume(const Args& a, const Layout& l, int wg) {
  using C = Cfg<KP, AUTO>;
  constexpr int KS = C::KS, N = C::N, MT = C::MT, H = C::H, S = C::S;
  constexpr int NH = N / 2;
  constexpr int U = H * MT;       // jobs of one unrolled round: 2 or 4
  const int tid = threadIdx.x - 128 * (wg + 1);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* const bufs =
      l.staging + (size_t)wg * 2 * C::ROWS * a.win;
  const int n_jobs = a.n_tiles * MT;

  uint32_t af[MT][KS][4];
  float acc[2][NH];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < NH; ++e) acc[s][e] = 0.f;
  int slot = 0, nbuf = 0;
  uint32_t phase = 0;
  int slot_of[2] = {};

  for (int rt = blockIdx.x; rt < a.row_tiles; rt += gridDim.x) {
    const int row_base = rt * (kConsumers * C::ROWS) + wg * C::ROWS;
    // The A fragments of both m64 tiles for the whole K, and sum_i n_i.
    float tot[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r0 = row_base + m * 64 + warp * 16 + g;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          af[m][ks][q] = load_pair(a, r0 + 8 * (q & 1),
                                   16 * ks + 2 * t + 8 * (q >> 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          s += (lo_bf16(af[m][ks][h]) + hi_bf16(af[m][ks][h])) +
               (lo_bf16(af[m][ks][2 + h]) + hi_bf16(af[m][ks][2 + h]));
        tot[m][h] = quad_sum(s);
        if (t == 0 && r0 + 8 * h < a.batch)
          a.total[r0 + 8 * h] = __float2bfloat16_rn(tot[m][h]);
      }
    }
    // The divisors' reciprocals: cross 1 / sum n of rows g and g + 8;
    // auto 1 / (sum n)^2 of the row whose sums the lane ends with (g + 8
    // (t & 1)).
    float inv[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (AUTO) {
        const float s = (t & 1) ? tot[m][1] : tot[m][0];
        inv[m][0] = inv[m][1] = 1.f / (s * s);
      } else {
        inv[m][0] = 1.f / tot[m][0];
        inv[m][1] = 1.f / tot[m][1];
      }
    }
    // The next row tile's density rows, into L2.
    {
      const int next = rt + gridDim.x;
      const int r = next * (kConsumers * C::ROWS) + wg * C::ROWS + tid;
      if (next < a.row_tiles && r < a.batch)
        for (int b = 0; b < a.nb; b += 64)
          hopper::prefetch_l2(a.ngal + (size_t)r * a.nb + b);
    }

    const int rows = min(C::ROWS, a.batch - row_base);
    int k0 = 0, kend = min(a.n_xi, a.win);
    __nv_bfloat16* buf = bufs + (size_t)(nbuf & 1) * C::ROWS * a.win;
    float part[MT][2] = {};
    // Job j: tile j / MT, m64 tile j % MT, accumulator set j & 1.
    issue_job<KP, AUTO>(a, l, 0, acc[0], af[0], slot_of[0], 0, slot, phase);
    for (int j0 = 0; j0 < n_jobs; j0 += U) {
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int j = j0 + q;
        if (j < n_jobs) {
          const int m = q % MT, half = (q / MT) % H, set = q & 1;
          const int T = j / MT;
          // The next job into the other set, then wait for this one.
          if (j + 1 < n_jobs) {
            const int np = (q + 1) % U;
            issue_job<KP, AUTO>(a, l, np, acc[set ^ 1], af[np % MT],
                                slot_of[set ^ 1], slot_of[set], slot,
                                phase);
            hopper::wgmma_wait<1>();
          } else {
            hopper::wgmma_wait<0>();
          }
#pragma unroll
          for (int e = 0; e < NH; ++e) hopper::fence_operand(acc[set][e]);
          if (m == MT - 1) release(l, slot_of[set]);

          // Fold (auto) or divide (cross) into the staging window.
          const int srow = m * 64 + warp * 16 + g;
          int kdone;
          if constexpr (AUTO) {
            // Lane t ends with row g + 8 (t & 1) of statistics 2 i + t / 2
            // of the tile (S >= 2), or of its one statistic (t < 2).
            const int row = srow + 8 * (t & 1);
            if constexpr (H == 1) {
              float v[2 * S], r[S >= 2 ? S / 2 : 1];
#pragma unroll
              for (int s = 0; s < S; ++s)
                fold<NH, KP / 8, KS>(acc[set], af[m], s * (KP / 8), 0,
                                     v[2 * s], v[2 * s + 1]);
              quad_reduce<2 * S>(v, r, t);
#pragma unroll
              for (int i = 0; i < (S >= 2 ? S / 2 : 1); ++i) {
                const int k = T * S + (S >= 2 ? 2 * i + (t >> 1) : 0);
                store_if(buf + (size_t)row * a.win + k - k0,
                         r[i] * inv[m][0],
                         k < a.n_xi && (S >= 2 || t < 2));
              }
              kdone = (T + 1) * S;
            } else {
              float v[2], r[1];
              if (half == 0) {
                fold<NH, N / 8, KS>(acc[set], af[m], 0, 0, part[m][0],
                                    part[m][1]);
                kdone = 0;
              } else {
                fold<NH, N / 8, KS>(acc[set], af[m], 0, N / 8, v[0], v[1]);
                v[0] += part[m][0];
                v[1] += part[m][1];
                quad_reduce<2>(v, r, t);
                const int k = T / 2;
                store_if(buf + (size_t)row * a.win + k - k0,
                         r[0] * inv[m][0], t < 2);
                kdone = k + 1;
              }
            }
          } else {
#pragma unroll
            for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int k = T * 64 + 8 * jj + 2 * t + e;
                  store_if(buf + (size_t)(srow + 8 * h) * a.win + k - k0,
                           acc[set][4 * jj + 2 * h + e] * inv[m][h],
                           k < a.n_xi);
                }
            kdone = (T + 1) * 64;
          }
          // A window is complete once its statistics are in for both m64
          // tiles: write it out; the next goes to the other buffer.
          if (m == MT - 1 && kdone >= kend) {
            hopper::named_sync(1 + wg, 128);
            flush(a, buf, row_base, rows, k0, kend - k0, tid);
            k0 = kend;
            kend = min(a.n_xi, k0 + a.win);
            ++nbuf;
            buf = bufs + (size_t)(nbuf & 1) * C::ROWS * a.win;
          }
        }
      }
    }
    hopper::wgmma_wait<0>();   // nothing in flight when A is reloaded
  }
}

// The producer: one thread streams every column tile through the ring,
// once per row tile of the block.
template <int KP, bool AUTO>
__device__ void produce(const Args& a, const Layout& l) {
  using C = Cfg<KP, AUTO>;
  constexpr uint32_t kTileBytes = C::N * KP * 2;
  int slot = 0;
  uint32_t phase = 0;
  for (int rt = blockIdx.x; rt < a.row_tiles; rt += gridDim.x)
    for (int T = 0; T < a.n_tiles; ++T) {
      hopper::mbar_wait(l.empty + 8 * slot, phase ^ 1);
      hopper::mbar_arrive_expect_tx(l.full + 8 * slot, kTileBytes);
      hopper::bulk_load(l.ring + slot * C::SLOT,
                        a.image + (size_t)T * (kTileBytes / 2), kTileBytes,
                        l.full + 8 * slot);
      advance(slot, phase, a.stages);
    }
}

// Warpgroup 0 produces, warpgroups 1 and 2 consume.
template <int KP, bool AUTO>
__global__ void __launch_bounds__(128 * (kConsumers + 1), 1)
    contraction_bf16_kernel(const Args args) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout(smem, args.stages, Cfg<KP, AUTO>::SLOT);
  init_barriers(l, args.stages);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<KP, AUTO>(args, l);
  } else {
    hopper::regs_inc<kConsumerRegs>();
    consume<KP, AUTO>(args, l, wg - 1);
  }
}

}  // namespace reg

// ======================================================================
// The streamed kernel (kp > 160)
// ======================================================================
namespace stream {

constexpr int kRows = 64 * kConsumers;    // rows of a row tile
constexpr int kABytes = kRows * 128;      // its 64-bin density box

template <int N>
struct Cfg {
  static constexpr int SLOT = kABytes + N * 128;
};

// A consumer warpgroup: rows [64 wg, 64 wg + 64) of each row tile.
template <int N, bool AUTO>
__device__ void consume(const Args& a, const Layout& l) {
  constexpr int SLOT = Cfg<N>::SLOT, NH = N / 2;
  const int n_chunks = a.kp / 64;

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* const bufs = l.staging + (size_t)wg * 2 * 64 * a.win;
  const int tiles_per_stat = a.kp / 64;    // auto
  float acc[NH];
#pragma unroll
  for (int e = 0; e < NH; ++e) acc[e] = 0.f;
  int slot = 0, nbuf = 0;
  uint32_t phase = 0;

  for (int rt = blockIdx.x; rt < a.row_tiles; rt += gridDim.x) {
    const int row0 = rt * kRows + wg * 64;
    const int ra = row0 + warp * 16 + g, rb = ra + 8;
    const int rows = min(64, a.batch - row0);
    float tot0 = 0.f, tot1 = 0.f, inv0 = 0.f, inv1 = 0.f, p0 = 0.f, p1 = 0.f;
    int k0 = 0, kend = min(a.n_xi, a.win);
    __nv_bfloat16* buf = bufs + (size_t)(nbuf & 1) * 64 * a.win;
    for (int T = 0; T < a.n_tiles; ++T) {
      int prev = 0;
      for (int c = 0; c < n_chunks; ++c) {
        hopper::mbar_wait(l.full + 8 * slot, phase);
        const uint32_t sa = l.ring + slot * SLOT;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_bf16_ss<N>(
              acc, hopper::desc_kmajor(sa + wg * 64 * 128 + 32 * kk, 128),
              hopper::desc_kmajor(sa + kABytes + 32 * kk, 128),
              (c | kk) != 0);
        hopper::wgmma_commit();
        if (c > 0) {
          hopper::wgmma_wait<1>();
          release(l, prev);
        }
        prev = slot;
        advance(slot, phase, a.stages);
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < NH; ++e) hopper::fence_operand(acc[e]);
      release(l, prev);

      // Column 0 of tile 0 is sum_j n_j (lane t = 0 of the quad holds it).
      if (T == 0) {
        tot0 = __shfl_sync(0xffffffffu, acc[0], lane & ~3);
        tot1 = __shfl_sync(0xffffffffu, acc[2], lane & ~3);
        if (t == 0 && ra < a.batch) a.total[ra] = __float2bfloat16_rn(tot0);
        if (t == 0 && rb < a.batch) a.total[rb] = __float2bfloat16_rn(tot1);
        inv0 = 1.f / tot0;
        inv1 = 1.f / tot1;
      }
      bool complete = false;
      if constexpr (!AUTO) {
        // Column c of tile T is statistic T N + c - 1; each tile is a
        // window of its own.
        k0 = max(0, T * N - 1);
        kend = min(a.n_xi, T * N + N - 1);
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = T * N + 8 * jj + 2 * t + e - 1;
              store_if(buf + (size_t)(warp * 16 + g + 8 * h) * a.win + k - k0,
                       acc[4 * jj + 2 * h + e] * (h ? inv1 : inv0),
                       k >= k0 && k < kend);
            }
        complete = true;
      } else if (T > 0) {
        // Tile q of statistic k: bins 64 q + [0, 64).
        const int u = T - 1, k = u / tiles_per_stat;
        const int q = u - k * tiles_per_stat;
#pragma unroll
        for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bin = 64 * q + 8 * jj + 2 * t + e;
            const bool in = bin < a.nb;
            const float na = __bfloat162float(
                a.ngal[in && ra < a.batch ? (size_t)ra * a.nb + bin : 0]);
            const float nb_ = __bfloat162float(
                a.ngal[in && rb < a.batch ? (size_t)rb * a.nb + bin : 0]);
            p0 = fmaf(acc[4 * jj + e], in && ra < a.batch ? na : 0.f, p0);
            p1 = fmaf(acc[4 * jj + 2 + e], in && rb < a.batch ? nb_ : 0.f,
                      p1);
          }
        if (q == tiles_per_stat - 1) {
          const float v0 = quad_sum(p0), v1 = quad_sum(p1);
          p0 = p1 = 0.f;
          const int srow = warp * 16 + g;
          store_if(buf + (size_t)srow * a.win + k - k0, v0 / (tot0 * tot0),
                   t == 0);
          store_if(buf + (size_t)(srow + 8) * a.win + k - k0,
                   v1 / (tot1 * tot1), t == 1);
          complete = k + 1 >= kend;
        }
      }
      if (complete) {
        hopper::named_sync(1 + wg, 128);
        flush(a, buf, row0, rows, k0, kend - k0, tid);
        k0 = kend;
        kend = min(a.n_xi, k0 + a.win);
        ++nbuf;
        buf = bufs + (size_t)(nbuf & 1) * 64 * a.win;
      }
    }
  }
}

// The producer warp after the two consumer warpgroups.
template <int N, bool AUTO>
__global__ void __launch_bounds__(128 * kConsumers + 32, 2)
    contraction_bf16_stream_kernel(const Args a,
                                   const __grid_constant__ CUtensorMap tmap) {
  constexpr int SLOT = Cfg<N>::SLOT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = layout(smem, a.stages, SLOT);
  init_barriers(l, a.stages);
  const int n_chunks = a.kp / 64;

  if (threadIdx.x >= 128 * kConsumers) {
    // The producer: per row tile, column tile and 64-bin chunk, the
    // densities' box and the matrix's chunk into one slot.
    if (threadIdx.x == 128 * kConsumers) {
      int slot = 0;
      uint32_t phase = 0;
      for (int rt = blockIdx.x; rt < a.row_tiles; rt += gridDim.x)
        for (int T = 0; T < a.n_tiles; ++T)
          for (int c = 0; c < n_chunks; ++c) {
            hopper::mbar_wait(l.empty + 8 * slot, phase ^ 1);
            const uint32_t dst = l.ring + slot * SLOT;
            hopper::mbar_arrive_expect_tx(l.full + 8 * slot, SLOT);
            hopper::tensor_load_2d(dst, &tmap, 64 * c, rt * kRows,
                                   l.full + 8 * slot);
            hopper::bulk_load(
                dst + kABytes,
                a.image + ((size_t)T * n_chunks + c) * (N * 64), N * 128,
                l.full + 8 * slot);
            advance(slot, phase, a.stages);
          }
    }
  } else {
    consume<N, AUTO>(a, l);
  }
}

}  // namespace stream

// ---- launch ----------------------------------------------------------
int setup_error(cudaError_t err) {
  cudaGetLastError();   // not left as the next launch's error
  return (int)err;
}

template <class Kernel>
int grid_size(Kernel kernel, int threads, size_t smem, int row_tiles,
              int device, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return setup_error(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return setup_error(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return setup_error(err);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = min(row_tiles, sms * per_sm);
  return 0;
}

template <int KP, bool AUTO>
int launch_reg(Args a, int cols, int device, cudaStream_t stream) {
  using C = reg::Cfg<KP, AUTO>;
  const int expect_tiles = !AUTO ? (a.n_xi + 63) / 64
                           : C::H == 2 ? 2 * a.n_xi
                                       : (a.n_xi + C::S - 1) / C::S;
  if (cols != C::N || a.n_tiles != expect_tiles ||
      (a.win != a.n_xi && (a.win % C::S != 0 || a.win % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.stages, C::SLOT, C::ROWS, a.win);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = reg::contraction_bf16_kernel<KP, AUTO>;
  const int threads = 128 * (kConsumers + 1);
  a.row_tiles = (a.batch + kConsumers * C::ROWS - 1) / (kConsumers * C::ROWS);
  int blocks = 0;
  const int err = grid_size(kernel, threads, smem, a.row_tiles, device,
                            &blocks);
  if (err != 0) return err;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool AUTO>
int launch_reg_mode(const Args& a, int cols, int device,
                    cudaStream_t stream) {
  switch (a.kp) {
    case 32: return launch_reg<32, AUTO>(a, cols, device, stream);
    case 64: return launch_reg<64, AUTO>(a, cols, device, stream);
    case 96: return launch_reg<96, AUTO>(a, cols, device, stream);
    case 128: return launch_reg<128, AUTO>(a, cols, device, stream);
    case 160: return launch_reg<160, AUTO>(a, cols, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    else
      cudaGetLastError();
  }
  return fn;
}

template <int N, bool AUTO>
int launch_stream(Args a, int device, cudaStream_t stream) {
  using C = stream::Cfg<N>;
  const int expect_tiles = AUTO ? 1 + a.n_xi * (a.kp / 64)
                                : (a.n_xi + 1 + N - 1) / N;
  const int expect_win = AUTO ? min(a.n_xi, 64)
                              : (expect_tiles == 1 ? a.n_xi : N);
  if (a.n_tiles != expect_tiles || a.win != expect_win || a.nb % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(a.ngal) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.stages, C::SLOT, 64, a.win);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // The densities as a 2-D tensor (bins innermost), boxes of 64 bins x
  // kRows rows, 128-byte swizzle, zeros outside.
  CUtensorMap tmap;
  const cuuint64_t dims[2] = {(cuuint64_t)a.nb, (cuuint64_t)a.batch};
  const cuuint64_t strides[1] = {(cuuint64_t)a.nb * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)stream::kRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(a.ngal), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = stream::contraction_bf16_stream_kernel<N, AUTO>;
  const int threads = 128 * kConsumers + 32;
  a.row_tiles = (a.batch + stream::kRows - 1) / stream::kRows;
  int blocks = 0;
  const int err = grid_size(kernel, threads, smem, a.row_tiles, device,
                            &blocks);
  if (err != 0) return err;
  kernel<<<blocks, threads, smem, stream>>>(a, tmap);
  return (int)cudaGetLastError();
}

}  // namespace bf16
}  // namespace tabcorr

extern "C" {

// Launch the bfloat16 contraction on `stream`: `ngal` (batch, nb) and the
// column tiles `image` (n_tiles, cols * kp) of
// ops/fused.py:bf16_table_constants, both contiguous bfloat16 on
// `device`; `out_total` (batch,) and `out_xi` (batch, n_xi) bfloat16.
// kp <= 160 runs the registers kernel (kp a multiple of 32), wider tables
// the streamed one (kp a multiple of 64, nb a multiple of 8, ngal 16-byte
// aligned).  `stages` ring slots, `win` statistics a staging window
// (ops/fused.py:bf16_launch_config).  Returns the CUDA error code of the
// launch (0 on success); the kernel runs asynchronously.
int tabcorr_contraction_bf16(const void* ngal, int batch, int nb, int kp,
                             const void* image, int n_xi, int is_auto,
                             int cols, int n_tiles, int stages, int win,
                             void* out_total, void* out_xi, int device,
                             void* stream) {
  using namespace tabcorr::bf16;
  if (batch < 0 || nb < 1 || kp < nb || n_xi < 1 || n_tiles < 1 ||
      stages < 2 || stages > kMaxStages || win < 1 || win > n_xi)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return setup_error(err);
  if (batch == 0) return 0;
  Args args = {};
  args.ngal = static_cast<const __nv_bfloat16*>(ngal);
  args.image = static_cast<const __nv_bfloat16*>(image);
  args.total = static_cast<__nv_bfloat16*>(out_total);
  args.xi = static_cast<__nv_bfloat16*>(out_xi);
  args.batch = batch;
  args.nb = nb;
  args.kp = kp;
  args.n_xi = n_xi;
  args.n_tiles = n_tiles;
  args.stages = stages;
  args.win = win;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp <= 160)
    return is_auto ? launch_reg_mode<true>(args, cols, device, s)
                   : launch_reg_mode<false>(args, cols, device, s);
  if (kp % 64 != 0) return (int)cudaErrorInvalidValue;
  if (is_auto)
    return cols == 64 ? launch_stream<64, true>(args, device, s)
                      : (int)cudaErrorInvalidValue;
  return cols == 64    ? launch_stream<64, false>(args, device, s)
         : cols == 128 ? launch_stream<128, false>(args, device, s)
                       : (int)cudaErrorInvalidValue;
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
