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
// (a block adds at most 256 x its bucket's tracers to a cell; the wrapper
// holds that under 2^32); weighted channels add float32 pair weights in
// float64, in shared memory and then in global memory.
//
// Layout (ops/paircount.py: bucket_layout, torch ops on the card): the
// i-tracers sorted by (label_1, z) and cut into tiles of at most 256 of one
// label; the j-tracers sorted by (label_2, z) (in auto mode the same
// array).  One block per (tile, label_2 bucket): one thread per i-tracer,
// held in registers, scans the j-tracers of the bucket in the tile's
// periodic z-window -- at most two runs of the sorted bucket, found before
// the launch by binary search (the whole bucket where the sweep has no
// window) -- staged through shared memory 256 at a time, and adds to a
// block-private histogram of n_channels x n_bins cells, flushed once.  This
// is the reference's bin-pair task farm (tabcorr/tabcorr.py:846-922) as
// one launch.
//
// What bounds it on an H100: instruction throughput.  Each candidate
// costs ~20 FP32 and integer instructions before it is rejected (the
// minimum image, rp^2, the z or radius cut), and ~10 more with a shared
// atomic when it is kept; the bytes are a few per pair, from shared
// memory.  (The least the function needs over the same z-window
// candidates is 5-17 operations a candidate and 10-26 a kept pair:
// chip_smoke.py's bound_ops.)  The design keeps every candidate's work
// in registers, reads each staged j-tracer as one 16-byte broadcast,
// rejects out-of-range pairs before any bin search, and bins only kept
// pairs.  Not done yet: an xy cell list (most candidates of a z-window
// fail the radius cut), warp-aggregated bins (a warp's kept pairs often
// hit one cell and serialize its atomic), and 'proj' sweeps that skip far
// columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;      // i-tracers a block, j-tracers a stage
constexpr int kRppi = 0, kSmu = 1, kProj = 2;
// Pair weights: 0 unit counts (int64), 1 the j weight, 2 the j weight x
// ln(rp), 3 both (two channels).
constexpr int kCount = 0, kWeight = 1, kLogRp = 2, kBoth = 3;

struct PairArgs {
  const float4* pos1;       // (x, y, z, -) sorted by (label_1, z)
  const int* tile_label;    // per tile: its label_1
  const int* tile_start;    // per tile: its first i-tracer
  const int* tile_count;    // per tile: its i-tracers (1..256)
  const float4* pos2;       // (x, y, z, w) sorted by (label_2, z)
  const int* runs;          // (n_tiles, n_labels_2, 4): j runs [a0, b0), [a1, b1)
  const float* edges_sq;    // n_r + 1 squared radial edges, non-decreasing
  const float* mu_edges;    // n_mu + 1 mu edges, non-decreasing (smu)
  void* hist;               // int64 or float64 (n_ch, n_l1, n_l2, n_r[, n_mu])
  int n_labels_1, n_labels_2, n_r, n_mu, auto_mode;
  float px, py, pz;         // period
  float tx, ty, tz;         // the least float32 |d| that wraps, per axis
  float pi_max;
};

// upper_bound over e[0, n): the count of edges <= v.
__device__ __forceinline__ int count_le(const float* e, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float min_image(float d, float period,
                                           float thr) {
  return fabsf(d) >= thr ? __fsub_rn(d, copysignf(period, d)) : d;
}

template <int KIND, int PW>
__device__ __forceinline__ void add_pair(const PairArgs& a, float4 p,
                                         float4 q, const float* e_sq,
                                         const float* e_mu, void* hist) {
  const float dx = min_image(__fsub_rn(p.x, q.x), a.px, a.tx);
  const float dy = min_image(__fsub_rn(p.y, q.y), a.py, a.ty);
  const float rp_sq = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  int sub;
  if (KIND == kSmu) {
    const float dz = fabsf(min_image(__fsub_rn(p.z, q.z), a.pz, a.tz));
    const float s_sq = __fadd_rn(rp_sq, __fmul_rn(dz, dz));
    if (!(s_sq >= e_sq[0] && s_sq < e_sq[a.n_r])) return;
    const float s = __fsqrt_rn(s_sq);
    if (!(s > 0.0f)) return;
    const float mu = __fdiv_rn(dz, fmaxf(s, 1e-30f));
    const int s_bin = count_le(e_sq, a.n_r + 1, s_sq) - 1;
    const int mu_bin =
        min(max(count_le(e_mu, a.n_mu + 1, mu) - 1, 0), a.n_mu - 1);
    sub = s_bin * a.n_mu + mu_bin;
  } else {
    if (KIND == kRppi) {
      const float dz = fabsf(min_image(__fsub_rn(p.z, q.z), a.pz, a.tz));
      if (!(dz < a.pi_max)) return;
    }
    if (!(rp_sq >= e_sq[0] && rp_sq < e_sq[a.n_r])) return;
    sub = count_le(e_sq, a.n_r + 1, rp_sq) - 1;
  }
  if (PW == kCount) {
    atomicAdd(static_cast<unsigned int*>(hist) + sub, 1u);
    return;
  }
  double* h = static_cast<double*>(hist);
  if (PW == kWeight || PW == kBoth) atomicAdd(h + sub, (double)q.w);
  if (PW == kLogRp || PW == kBoth) {
    const float w_log =
        __fmul_rn(__fmul_rn(q.w, 0.5f), logf(fmaxf(rp_sq, 1e-20f)));
    const int channel = KIND == kSmu ? a.n_r * a.n_mu : a.n_r;
    atomicAdd(h + (PW == kBoth ? channel : 0) + sub, (double)w_log);
  }
}

template <int KIND, int PW>
__global__ void __launch_bounds__(kTile)
    paircount_kernel(const PairArgs a) {
  constexpr int kChannels = PW == kBoth ? 2 : 1;
  const int tile = blockIdx.x, l2 = blockIdx.y;
  const int* run = a.runs + ((size_t)tile * a.n_labels_2 + l2) * 4;
  const int a0 = run[0], b0 = run[1], a1 = run[2], b1 = run[3];
  if (a0 == b0 && a1 == b1) return;   // the whole block: nothing to scan

  const int n_hist_r = KIND == kSmu ? a.n_r * a.n_mu : a.n_r;
  const int cells = kChannels * n_hist_r;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* jt = reinterpret_cast<float4*>(smem);
  void* hist = smem + kTile * sizeof(float4);
  const size_t cell_bytes = PW == kCount ? 4 : 8;
  float* e_sq = reinterpret_cast<float*>(static_cast<unsigned char*>(hist) +
                                         cells * cell_bytes);
  float* e_mu = e_sq + a.n_r + 1;

  const int t = threadIdx.x;
  for (int c = t; c < cells; c += kTile) {
    if (PW == kCount) static_cast<unsigned int*>(hist)[c] = 0u;
    else static_cast<double*>(hist)[c] = 0.0;
  }
  for (int k = t; k <= a.n_r; k += kTile) e_sq[k] = a.edges_sq[k];
  if (KIND == kSmu)
    for (int k = t; k <= a.n_mu; k += kTile) e_mu[k] = a.mu_edges[k];

  const int l1 = a.tile_label[tile], i0 = a.tile_start[tile];
  const bool has_i = t < a.tile_count[tile];
  const float4 p = has_i ? a.pos1[i0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
  // In auto mode a tracer meets itself only in its own bucket; pos1 and
  // pos2 are then one array, so equal positions in it are one tracer.
  const int self = a.auto_mode && l1 == l2 ? i0 + t : -1;
  __syncthreads();

  for (int r = 0; r < 2; ++r) {
    const int ja = r ? a1 : a0, jb = r ? b1 : b0;
    for (int base = ja; base < jb; base += kTile) {
      const int nj = min(kTile, jb - base);
      if (t < nj) jt[t] = a.pos2[base + t];
      __syncthreads();
      if (has_i) {
        const int skip = self - base;   // the staged index of i itself
        for (int jj = 0; jj < nj; ++jj) {
          if (jj == skip) continue;
          add_pair<KIND, PW>(a, p, jt[jj], e_sq, e_mu, hist);
        }
      }
      __syncthreads();
    }
  }

  // Flush: one global atomic per non-zero cell.
  const size_t n_hist = (size_t)a.n_labels_1 * a.n_labels_2 * n_hist_r;
  const size_t cell0 = ((size_t)l1 * a.n_labels_2 + l2) * n_hist_r;
  for (int c = t; c < cells; c += kTile) {
    const int ch = c / n_hist_r, sub = c - ch * n_hist_r;
    const size_t at = ch * n_hist + cell0 + sub;
    if (PW == kCount) {
      const unsigned int v = static_cast<unsigned int*>(hist)[c];
      if (v)
        atomicAdd(static_cast<unsigned long long*>(a.hist) + at,
                  (unsigned long long)v);
    } else {
      const double v = static_cast<double*>(hist)[c];
      if (v != 0.0) atomicAdd(static_cast<double*>(a.hist) + at, v);
    }
  }
}

template <int KIND, int PW>
int launch(const PairArgs& a, int n_tiles, size_t smem, cudaStream_t s) {
  paircount_kernel<KIND, PW>
      <<<dim3(n_tiles, a.n_labels_2), kTile, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const PairArgs& a, int pw, int n_tiles, size_t smem,
                cudaStream_t s) {
  switch (pw) {
    case kCount: return launch<KIND, kCount>(a, n_tiles, smem, s);
    case kWeight: return launch<KIND, kWeight>(a, n_tiles, smem, s);
    case kLogRp: return launch<KIND, kLogRp>(a, n_tiles, smem, s);
    default: return launch<KIND, kBoth>(a, n_tiles, smem, s);
  }
}

}  // namespace

extern "C" {

// Launch the pair counter on `stream`: n_tiles tiles of i-tracers
// (`tile_label`, `tile_start`, `tile_count` into `pos1`) against the
// n_labels_2 buckets of `pos2`, each through its runs `runs` (n_tiles,
// n_labels_2, 4); `kind` 0 rppi, 1 smu, 2 proj; `pair_weight` 0 unit counts
// into the int64 `hist`, 1 weight, 2 weight x ln(rp), 3 both (two
// channels) into the float64 `hist`, which the caller zeroes.  `thr` per
// axis is the least float32 |d| that wraps (see the top of this file).
// Returns the CUDA error code of the launch (0 on success); the kernel runs
// asynchronously.
int tabcorr_paircount(const void* pos1, const int* tile_label,
                      const int* tile_start, const int* tile_count,
                      int n_tiles, const void* pos2, const int* runs,
                      int n_labels_1, int n_labels_2, int auto_mode,
                      int kind, int pair_weight, const float* edges_sq,
                      int n_r, const float* mu_edges, int n_mu, float px,
                      float py, float pz, float tx, float ty, float tz,
                      float pi_max, void* hist, int device, void* stream) {
  if (n_tiles < 0 || n_labels_1 < 1 || n_labels_2 < 1 ||
      n_labels_2 > 65535 || n_r < 1 || n_mu < 1 || kind < kRppi ||
      kind > kProj || pair_weight < kCount || pair_weight > kBoth)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  PairArgs a;
  a.pos1 = static_cast<const float4*>(pos1);
  a.tile_label = tile_label;
  a.tile_start = tile_start;
  a.tile_count = tile_count;
  a.pos2 = static_cast<const float4*>(pos2);
  a.runs = runs;
  a.edges_sq = edges_sq;
  a.mu_edges = mu_edges;
  a.hist = hist;
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
  const size_t smem = kTile * sizeof(float4) +
                      (size_t)channels * n_hist_r *
                          (pair_weight == kCount ? 4 : 8) +
                      (size_t)(n_r + 1 + n_mu + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRppi: return launch_kind<kRppi>(a, pair_weight, n_tiles, smem, s);
    case kSmu: return launch_kind<kSmu>(a, pair_weight, n_tiles, smem, s);
    default: return launch_kind<kProj>(a, pair_weight, n_tiles, smem, s);
  }
}

const char* tabcorr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
