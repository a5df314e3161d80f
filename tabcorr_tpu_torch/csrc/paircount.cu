// Labeled pair counter for Hopper (sm_90a).
//
// paircount_kernel: the labeled histogram of a tabulation sweep,
//
//     counts[label_1, label_2, bin] = sum over ordered pairs (i, j),
//                                     i of label_1, j of label_2,
//                                     pair in bin, of w(i, j),
//
// with periodic minimum-image separations, self-pairs excluded by index in
// auto mode, labels below 0 dropped before the launch, and the pair's bin
// one of three geometries: 'rppi' (projected radius, |dz| < pi_max), 'smu'
// (s and mu = |dz| / s) and 'proj' (projected radius, the whole z column).
// w is 1 (exact integer counts), the j-tracer's weight, or that weight
// times ln(rp) (the annulus-mean Delta Sigma estimator), one or two
// channels from one enumeration of the pairs.  It replaces the z-windowed
// XLA sweep of the JAX package, _sweep_impl / _sweep_block_impl
// (tabcorr_tpu/ops/paircount.py:130/276), which is not a Pallas kernel:
// there the histogram is a one-hot bilinear form on the MXU over 1024 x
// 1024 tiles of all labels, folded into a float32 TwoSum accumulator.
// None of that mechanism is carried over.
//
// The geometry is tabcorr_tpu's (_tile_geometry, :99-127) bit for bit in
// float32, so that this kernel and its plain version (ops/paircount.py:
// paircount_plain, the same expressions in tensor ops) give equal integer
// counts:
//
//   * d = p1 - p2, then d - period * rint(d / period).  The wrapper takes
//     coordinates in [0, period] only, so |d| <= period and rint(d /
//     period) is +-1 exactly when the correctly rounded |d| / period lies
//     above 0.5 (0.5 itself rounds half to even, to 0): exactly when |d|
//     is at least `thr`, the least float32 above period * (0.5 + 2^-25),
//     computed on the host.  The kernel compares against it, where the
//     JAX package divides.
//   * rp^2 = dx * dx + dy * dy and the smu terms with __fmul_rn / __fadd_rn:
//     nvcc would contract a * b + c into an FMA, which rounds once where
//     tabcorr_tpu rounds twice and moves a pair lying on a bin edge.
//   * The squared edges come rounded once from float64 to float32; a bin is
//     the count of edges at or below the value, minus one (a binary search
//     over the non-decreasing edges).  smu: s = sqrt(s^2) and mu = |dz| /
//     max(s, 1e-30), both correctly rounded, the mu bin clipped to [0,
//     n_mu - 1] and s > 0 required.  log_rp: (w * 0.5) * logf(max(rp^2,
//     1e-20)) in float32.
//
// Accumulation is exact: unit counts are 32-bit shared-memory atomics in a
// block, flushed once with 64-bit global atomics into an int64 histogram
// (a block visits each j-tracer of its label_2 at most once, so a cell
// gains at most 256 x that label's tracers; the wrapper holds that under
// 2^32); weighted channels add float32 pair weights in float64: in a
// private row of each thread where the rows of a block fit (the Delta
// Sigma sweep's 28 cells: no atomics), else with shared-memory atomics,
// then with global ones.
//
// Layout (ops/paircount.py: bucket_layout, torch ops on the card).  The
// j-side is one xy cell list per label_2: its tracers sorted by (cell, z),
// a column per (label_2, cell).  The i-side is cut into spatially compact
// tiles that mix labels: the tracers sorted by (label group, cell, z),
// tiles of at most 256 within one (group, cell), a label group being a run
// of consecutive labels_1 whose histogram rows fit the block's shared
// memory (one group where each thread keeps a private row).  One block
// per (tile, label_2): it scans the columns of its
// label_2 in the cells whose least periodic xy gap to the tile's cell is
// within the largest radial edge (the layout's `neighbours`, residues per
// axis so no cell repeats), each over the tile's z range widened by that
// offset's z reach (pi_max, or for smu the sphere's half-chord at the
// offset's gap): at most two runs of the column, found here by binary
// search (column_runs), staged through shared memory 256 j-tracers at a
// time across runs.  One thread per i-tracer adds into its own label's
// row of the group histogram (or its private row), flushed once.
//
// What bounds it on an H100: instruction throughput.  A candidate costs
// ~20 FP32 and integer instructions before it is rejected (the minimum
// image, rp^2, the z or radius cut) and a kept pair ~15-60 more (its bin
// by a branch-free search over edges padded to a power of two, its smu
// root and division, the shared add); the bytes are a few per pair,
// from shared memory.  The least the function needs is the kept pairs'
// geometry and bin (chip_smoke.py's kept-pair bound).  A tile of one
// label sorted in z spans the whole xy plane (labels are sparse), so every
// pair of its z-slab is a candidate (19% kept for wp; 8% for Delta Sigma,
// which has no z window); the cell lists cut the candidates 2.7-8x so that
// 36-65% are kept and a warp's kept path serves most of its lanes, and the
// per-label rows spread the atomics that one-label tiles put on one row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 256;    // threads: i-tracers a tile, j-tracers a stage
constexpr int kRunSlots = kTile;              // two runs a neighbour cell
constexpr int kMaxNeighbours = kRunSlots / 2;
constexpr int kRppi = 0, kSmu = 1, kProj = 2;
// Pair weights: 0 unit counts (int64), 1 the j weight, 2 the j weight x
// ln(rp), 3 both (two channels).
constexpr int kCount = 0, kWeight = 1, kLogRp = 2, kBoth = 3;

struct PairArgs {
  const float4* pos1;       // (x, y, z, -) sorted by (group, cell, z)
  const int* labels1;       // their label_1
  const int* index1;        // their index in the sweep (auto: self test)
  const int* tile_start;    // per tile: its first i-tracer
  const int* tile_count;    // per tile: its i-tracers (1..256)
  const int* tile_group;    // per tile: its label group
  const int* tile_cell;     // per tile: its cell, cx * n_cy + cy
  const int* group_start;   // (n_groups + 1): first label_1 of each group
  const float4* pos2;       // (x, y, z, w) sorted by (label_2, cell, z)
  const int* index2;        // their index in the sweep
  const int* columns;       // (n_labels_2 * n_cells + 1): column starts
  const int* neighbours;    // (n_nb, 2): cell offsets (rx, ry), residues
  const double* reach_z;    // (n_nb): each offset's z reach, < 0: none
  const float* edges_sq;    // n_r + 1 squared radial edges, non-decreasing
  const float* mu_edges;    // n_mu + 1 mu edges, non-decreasing (smu)
  void* hist;               // int64 or float64 (n_ch, n_l1, n_l2, n_r[, n_mu])
  unsigned long long* visited;   // pairs evaluated (nullable)
  int n_nb, n_cx, n_cy, group_rows;
  int n_labels_1, n_labels_2, n_r, n_mu, auto_mode;
  float px, py, pz;         // period
  float tx, ty, tz;         // the least float32 |d| that wraps, per axis
  float pi_max;
};

constexpr int kMaxSteps = 10;   // MAX_EDGES 512 in ops/paircount.py

// The halvings of a search over an edge list of n entries padded with +inf
// to 2^steps > n entries, so that it finds every count 0..n.
__host__ __device__ inline int search_steps(int n) {
  int steps = 0;
  while ((1 << steps) <= n) ++steps;
  return steps;
}

// The count of edges <= v over 2^STEPS padded edges: branch-free, unrolled
// (a loop with a run-time bound costs ~10 instructions a halving, this 3).
template <int STEPS>
__device__ __forceinline__ int count_le_steps(const float* e, float v) {
  int pos = 0;
#pragma unroll
  for (int k = STEPS - 1; k >= 0; --k)
    if (e[pos + (1 << k) - 1] <= v) pos += 1 << k;
  return pos;
}

// The radial search's depth, a template parameter chosen once a block: 4
// halvings up to 15 edges (every configuration of
// database.configuration), else kMaxSteps; the edges are padded with +inf
// to 2^depth.
__host__ __device__ inline int radial_steps(int n) {
  return search_steps(n) <= 4 ? 4 : kMaxSteps;
}

// A block's bins: the squared radial edges, padded, and the mu edges in
// shared memory; the range [lo, hi) of the radial edges in registers (the
// block's shared atomics could alias a shared copy, so the compiler would
// read it again for every pair); n_mu as a float.
struct Bins {
  const float* e_sq;
  const float* e_mu;
  float lo, hi, n_mu_f;
};

__device__ __forceinline__ float min_image(float d, float period,
                                           float thr) {
  return fabsf(d) >= thr ? __fsub_rn(d, copysignf(period, d)) : d;
}

// The first index of [lo, hi) in a z-sorted column whose z is at least u
// (above v for first_above); float64 comparisons, exact.
__device__ int first_at_or_above(const float4* p, int lo, int hi, double u) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((double)__ldg(&p[mid].z) < u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ int first_above(const float4* p, int lo, int hi, double v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((double)__ldg(&p[mid].z) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Neighbour k's column of label_2 l2: its j-runs [a0, b0) and [cs, b1)
// (the second before the first, empty unless the window wraps) into run
// slots 2k and 2k + 1 -- the tracers within the offset's z reach of the
// tile's z range [z_lo, z_hi] across the periodic boundary, or the whole
// column.  ops/paircount.py pair_runs is this in tensor ops.
__device__ void column_runs(const PairArgs& a, int k, int cx, int cy, int l2,
                            float z_lo, float z_hi, int* run_a, int* run_n) {
  int ncx = cx + a.neighbours[2 * k], ncy = cy + a.neighbours[2 * k + 1];
  if (ncx >= a.n_cx) ncx -= a.n_cx;
  if (ncy >= a.n_cy) ncy -= a.n_cy;
  const int col = l2 * (a.n_cx * a.n_cy) + ncx * a.n_cy + ncy;
  const int cs = a.columns[col], ce = a.columns[col + 1];
  int a0 = cs, b0 = ce, b1 = cs;
  const double zc = a.reach_z[k], pz = a.pz;
  if (zc >= 0.0 && cs < ce) {
    const double lo = (double)z_lo - zc, hi = (double)z_hi + zc;
    if (hi - lo < pz) {
      const bool wrap_lo = lo <= 0.0, wrap_hi = !wrap_lo && hi >= pz;
      a0 = first_at_or_above(a.pos2, cs, ce, wrap_lo ? lo + pz : lo);
      b0 = first_above(a.pos2, a0, ce, wrap_lo || wrap_hi ? pz + 1.0 : hi);
      if (wrap_lo || wrap_hi)
        b1 = min(first_above(a.pos2, cs, ce, wrap_lo ? hi : hi - pz), a0);
    }
  }
  run_a[2 * k] = a0;
  run_n[2 * k] = b0 - a0;
  run_a[2 * k + 1] = cs;
  run_n[2 * k + 1] = b1 - cs;
}

__device__ __forceinline__ void flush_add(unsigned long long* h,
                                          unsigned int v) {
  atomicAdd(h, (unsigned long long)v);
}

__device__ __forceinline__ void flush_add(double* h, double v) {
  atomicAdd(h, v);
}

// One candidate pair: i at p (this thread), j at q, staged as jj.  `row`
// is this thread's row -- its label's row of the group histogram, or its
// private row -- and `stride` the offset of the second channel from it.
// PRIVATE: plain float64 adds to the thread's own row (exact, no atomics:
// a float64 atomicAdd to shared memory compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN.64, on sm_90a); unit counts add with ATOMS.POPC.INC.
template <int KIND, int PW, bool PRIVATE, int STEPS_R, typename Cell>
__device__ __forceinline__ void add_pair(const PairArgs& a, const Bins& b,
                                         float4 p, float4 q, int jj,
                                         int self, const int* jid,
                                         Cell* row, int stride) {
  // Every cut of a candidate folded into one branch (& on the tests, not
  // &&: no branch a test).
  const float dx = min_image(__fsub_rn(p.x, q.x), a.px, a.tx);
  const float dy = min_image(__fsub_rn(p.y, q.y), a.py, a.ty);
  const float rp_sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  int sub;
  if (KIND == kSmu) {
    const float dz = fabsf(min_image(__fsub_rn(p.z, q.z), a.pz, a.tz));
    const float s_sq = __fadd_rn(rp_sq, __fmul_rn(dz, dz));
    if (!((s_sq >= b.lo) & (s_sq < b.hi))) return;
    const float s = __fsqrt_rn(s_sq);
    if (!(s > 0.0f)) return;          // also the self-pair
    const float mu = __fdiv_rn(dz, fmaxf(s, 1e-30f));
    const int s_bin = count_le_steps<STEPS_R>(b.e_sq, s_sq) - 1;
    // The mu bin, clip(count of edges <= mu - 1, 0, n_mu - 1): guessed as
    // for uniform edges (mu lies in [0, 1] up to an ulp), then moved to
    // the last bin whose lower edge is <= mu -- exact for any
    // non-decreasing edges, one or two compares for uniform ones.
    int mu_bin = min(__float2int_rz(__fmul_rn(mu, b.n_mu_f)), a.n_mu - 1);
    while (mu_bin > 0 && b.e_mu[mu_bin] > mu) --mu_bin;
    while (mu_bin < a.n_mu - 1 && b.e_mu[mu_bin + 1] <= mu) ++mu_bin;
    sub = s_bin * a.n_mu + mu_bin;
  } else {
    bool keep = (rp_sq >= b.lo) & (rp_sq < b.hi);
    if (KIND == kRppi) {
      const float dz = fabsf(min_image(__fsub_rn(p.z, q.z), a.pz, a.tz));
      keep &= dz < a.pi_max;
    }
    if (!keep) return;
    if (rp_sq == 0.0f && jid[jj] == self) return;   // self is -1 in cross
    sub = count_le_steps<STEPS_R>(b.e_sq, rp_sq) - 1;
  }
  if constexpr (PW == kCount) {
    atomicAdd(row + sub, 1u);
  } else {
    Cell* at = row + sub;
    if (PW == kWeight || PW == kBoth) {
      if (PRIVATE) *at += (double)q.w; else atomicAdd(at, (double)q.w);
    }
    if (PW == kLogRp || PW == kBoth) {
      const float w_log =
          __fmul_rn(__fmul_rn(q.w, 0.5f), logf(fmaxf(rp_sq, 1e-20f)));
      if (PW == kBoth) at += stride;
      if (PRIVATE) *at += (double)w_log; else atomicAdd(at, (double)w_log);
    }
  }
}

// One stage: this thread's i-tracer against the nj staged j-tracers.
template <int KIND, int PW, bool PRIVATE, int STEPS_R, typename Cell>
__device__ __forceinline__ void scan_stage(const PairArgs& a, const Bins& b,
                                           float4 p, int nj,
                                           const float4* jt, int self,
                                           const int* jid, Cell* row,
                                           int stride) {
  for (int jj = 0; jj < nj; ++jj)
    add_pair<KIND, PW, PRIVATE, STEPS_R>(a, b, p, jt[jj], jj, self, jid,
                                         row, stride);
}

// PRIVATE (weighted sweeps whose rows fit): each thread adds into a
// private float64 row of n_channels x n_hist_r cells (an odd stride of
// 8-byte words, to spread the banks), flushed per thread; else a group
// histogram of group_rows label rows per channel, shared by the block.
template <int KIND, int PW, bool PRIVATE>
__global__ void __launch_bounds__(kTile)
    paircount_kernel(const PairArgs a) {
  using Cell = typename std::conditional<PW == kCount, unsigned int,
                                         double>::type;
  constexpr int kChannels = PW == kBoth ? 2 : 1;
  __shared__ float4 jt[kTile];
  __shared__ int jid[kTile];
  __shared__ int run_a[kRunSlots], run_n[kRunSlots];
  __shared__ int run_p[kRunSlots + 1];
  __shared__ int warp_total[kTile / 32];
  extern __shared__ __align__(16) unsigned char smem[];

  const int t = threadIdx.x, tile = blockIdx.x, l2 = blockIdx.y;
  const int i0 = a.tile_start[tile], ni = a.tile_count[tile];
  const int group = a.tile_group[tile];
  const int g0 = a.group_start[group];
  const int rows = a.group_start[group + 1] - g0;
  const int cell = a.tile_cell[tile];
  const int cx = cell / a.n_cy, cy = cell - cx * a.n_cy;

  // The block's j-runs, two a neighbour cell, and their prefix sums.
  if (t < kMaxNeighbours) {
    if (t < a.n_nb) {
      column_runs(a, t, cx, cy, l2, a.pos1[i0].z, a.pos1[i0 + ni - 1].z,
                  run_a, run_n);
    } else {
      run_a[2 * t] = run_a[2 * t + 1] = 0;
      run_n[2 * t] = run_n[2 * t + 1] = 0;
    }
  }
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  int v = run_n[t];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kTile / 32 ? warp_total[lane] : 0;
#pragma unroll
    for (int o = 1; o < kTile / 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kTile / 32) warp_total[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_total[warp - 1];
  run_p[t + 1] = v;
  if (t == 0) run_p[0] = 0;
  __syncthreads();
  const int n_j = run_p[kRunSlots];
  if (n_j == 0) return;               // the whole block: nothing to scan
  if (t == 0 && a.visited)
    atomicAdd(a.visited, (unsigned long long)ni * (unsigned long long)n_j);

  const int n_hist_r = KIND == kSmu ? a.n_r * a.n_mu : a.n_r;
  const int private_stride = (kChannels * n_hist_r) | 1;
  // The second channel's offset from a row; all cells of the histogram.
  const int stride = PRIVATE ? n_hist_r : a.group_rows * n_hist_r;
  const int cells = PRIVATE ? kTile * private_stride : kChannels * stride;
  Bins bins;
  const int steps_r = radial_steps(a.n_r + 1);
  const int len_r = 1 << steps_r, len_mu = a.n_mu + 1;
  bins.n_mu_f = (float)a.n_mu;
  Cell* hist = reinterpret_cast<Cell*>(smem);
  float* e_sq = reinterpret_cast<float*>(hist + cells);
  float* e_mu = e_sq + len_r;
  bins.e_sq = e_sq;
  bins.e_mu = e_mu;
  bins.lo = a.edges_sq[0];
  bins.hi = a.edges_sq[a.n_r];
  for (int c = t; c < cells; c += kTile) hist[c] = Cell(0);
  for (int k = t; k < len_r; k += kTile)
    e_sq[k] = k <= a.n_r ? a.edges_sq[k] : INFINITY;
  if (KIND == kSmu)
    for (int k = t; k < len_mu; k += kTile) e_mu[k] = a.mu_edges[k];

  const bool has_i = t < ni;
  const float4 p = has_i ? a.pos1[i0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int l1 = has_i ? a.labels1[i0 + t] : g0;
  Cell* row = PRIVATE ? hist + t * private_stride
                      : hist + (l1 - g0) * n_hist_r;
  const int self = a.auto_mode && has_i ? a.index1[i0 + t] : -1;
  __syncthreads();

  for (int base = 0; base < n_j; base += kTile) {
    const int g = base + t;
    if (g < n_j) {
      int r = 0;   // the last run slot starting at or before g
#pragma unroll
      for (int s = kRunSlots / 2; s > 0; s >>= 1)
        if (run_p[r + s] <= g) r += s;
      const int j = run_a[r] + (g - run_p[r]);
      jt[t] = a.pos2[j];
      jid[t] = a.index2[j];
    }
    __syncthreads();
    if (has_i) {
      const int nj = min(kTile, n_j - base);
      if (steps_r == 4)
        scan_stage<KIND, PW, PRIVATE, 4>(a, bins, p, nj, jt, self, jid, row,
                                         stride);
      else
        scan_stage<KIND, PW, PRIVATE, kMaxSteps>(a, bins, p, nj, jt, self,
                                                 jid, row, stride);
    }
    __syncthreads();
  }

  // Flush: one global atomic per non-zero cell, each thread its private
  // row, or the block this group's rows.
  using Global = typename std::conditional<PW == kCount, unsigned long long,
                                           double>::type;
  Global* out = static_cast<Global*>(a.hist);
  const size_t n_hist = (size_t)a.n_labels_1 * a.n_labels_2 * n_hist_r;
  if (PRIVATE) {
    if (!has_i) return;
    for (int c = 0; c < kChannels * n_hist_r; ++c) {
      const int ch = c / n_hist_r, sub = c - ch * n_hist_r;
      if (row[c] != Cell(0))
        flush_add(out + ch * n_hist +
                      ((size_t)l1 * a.n_labels_2 + l2) * n_hist_r + sub,
                  row[c]);
    }
    return;
  }
  const int used = rows * n_hist_r;
  for (int c = t; c < kChannels * used; c += kTile) {
    const int ch = c / used, rest = c - ch * used;
    const int r = rest / n_hist_r, sub = rest - r * n_hist_r;
    const Cell value = hist[ch * stride + rest];
    if (value != Cell(0))
      flush_add(out + ch * n_hist +
                    ((size_t)(g0 + r) * a.n_labels_2 + l2) * n_hist_r + sub,
                value);
  }
}

template <int KIND, int PW, bool PRIVATE>
int launch(const PairArgs& a, int n_tiles, size_t smem, cudaStream_t s) {
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      paircount_kernel<KIND, PW, PRIVATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left as the next launch's error
    return (int)err;
  }
  paircount_kernel<KIND, PW, PRIVATE>
      <<<dim3(n_tiles, a.n_labels_2), kTile, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, int PW>
int launch_rows(const PairArgs& a, bool private_rows, int n_tiles,
                size_t smem, cudaStream_t s) {
  return private_rows ? launch<KIND, PW, true>(a, n_tiles, smem, s)
                      : launch<KIND, PW, false>(a, n_tiles, smem, s);
}

template <int KIND>
int launch_kind(const PairArgs& a, int pw, bool private_rows, int n_tiles,
                size_t smem, cudaStream_t s) {
  switch (pw) {
    case kCount: return launch<KIND, kCount, false>(a, n_tiles, smem, s);
    case kWeight:
      return launch_rows<KIND, kWeight>(a, private_rows, n_tiles, smem, s);
    case kLogRp:
      return launch_rows<KIND, kLogRp>(a, private_rows, n_tiles, smem, s);
    default:
      return launch_rows<KIND, kBoth>(a, private_rows, n_tiles, smem, s);
  }
}

}  // namespace

extern "C" {

// Launch the pair counter on `stream`: n_tiles tiles of i-tracers
// (`tile_start`, `tile_count`, `tile_group`, `tile_cell` into `pos1`,
// `labels1`, `index1`; `group_start` the label groups, `group_rows` the
// most labels of one) against the n_labels_2 cell lists of `pos2` /
// `index2` (`columns`: the start of each (label_2, cell) column, n_cx x
// n_cy cells), over the n_nb cell offsets `neighbours` (rx, ry) with z
// reach `reach_z` each; `kind` 0 rppi, 1 smu, 2 proj; `pair_weight` 0 unit
// counts into the int64 `hist`, 1 weight, 2 weight x ln(rp), 3 both (two
// channels) into the float64 `hist`, which the caller zeroes;
// `private_rows` (weighted only): per-thread rows instead of the group
// histogram (one group of every label).  `thr` per
// axis is the least float32 |d| that wraps (see the top of this file).
// `visited`, unless null, gains the pairs evaluated.  Returns the CUDA
// error code of the launch (0 on success); the kernel runs asynchronously.
int tabcorr_paircount(const void* pos1, const int* labels1,
                      const int* index1, const int* tile_start,
                      const int* tile_count, const int* tile_group,
                      const int* tile_cell, int n_tiles,
                      const int* group_start, int group_rows,
                      const void* pos2, const int* index2,
                      const int* columns, const int* neighbours,
                      const double* reach_z, int n_nb, int n_cx, int n_cy,
                      int n_labels_1, int n_labels_2, int auto_mode,
                      int kind, int pair_weight, const float* edges_sq,
                      int n_r, const float* mu_edges, int n_mu, float px,
                      float py, float pz, float tx, float ty, float tz,
                      float pi_max, int private_rows, void* hist,
                      unsigned long long* visited, int device,
                      void* stream) {
  if (n_tiles < 0 || n_labels_1 < 1 || n_labels_2 < 1 ||
      n_labels_2 > 65535 || n_r < 1 || n_mu < 1 || kind < kRppi ||
      kind > kProj || pair_weight < kCount || pair_weight > kBoth ||
      n_nb < 1 || n_nb > kMaxNeighbours || n_cx < 1 || n_cy < 1 ||
      group_rows < 1 || group_rows > n_labels_1 ||
      (private_rows && (pair_weight == kCount || group_rows != n_labels_1)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  PairArgs a;
  a.pos1 = static_cast<const float4*>(pos1);
  a.labels1 = labels1;
  a.index1 = index1;
  a.tile_start = tile_start;
  a.tile_count = tile_count;
  a.tile_group = tile_group;
  a.tile_cell = tile_cell;
  a.group_start = group_start;
  a.pos2 = static_cast<const float4*>(pos2);
  a.index2 = index2;
  a.columns = columns;
  a.neighbours = neighbours;
  a.reach_z = reach_z;
  a.edges_sq = edges_sq;
  a.mu_edges = mu_edges;
  a.hist = hist;
  a.visited = visited;
  a.n_nb = n_nb;
  a.n_cx = n_cx;
  a.n_cy = n_cy;
  a.group_rows = group_rows;
  a.n_labels_1 = n_labels_1;
  a.n_labels_2 = n_labels_2;
  a.n_r = n_r;
  a.n_mu = n_mu;
  a.auto_mode = auto_mode;
  a.px = px; a.py = py; a.pz = pz;
  a.tx = tx; a.ty = ty; a.tz = tz;
  a.pi_max = pi_max;
  const int n_hist_r = kind == kSmu ? n_r * n_mu : n_r;
  const int channels = pair_weight == kBoth ? 2 : 1;
  const size_t hist_cells =
      private_rows ? (size_t)kTile * ((channels * n_hist_r) | 1)
                   : (size_t)channels * group_rows * n_hist_r;
  const size_t smem =
      hist_cells * (pair_weight == kCount ? 4 : 8) +
      (size_t)((1 << radial_steps(n_r + 1)) + n_mu + 1) * sizeof(float);
  const bool pr = private_rows != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRppi:
      return launch_kind<kRppi>(a, pair_weight, pr, n_tiles, smem, s);
    case kSmu:
      return launch_kind<kSmu>(a, pair_weight, pr, n_tiles, smem, s);
    default:
      return launch_kind<kProj>(a, pair_weight, pr, n_tiles, smem, s);
  }
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
