// Native cell-list pair counters for the host-side tabulation path.
//
// Role: the CPU production equivalent of the Corrfunc kernels the reference
// wraps (reference: tabcorr/corrfunc.py) — periodic-box pair counts in
// (rp, pi), (s, mu) and projected-rp geometries, generalized to carry an
// integer bin label per tracer so one sweep fills the whole
// counts[label1, label2, r] tensor (the same labeled-histogram design as
// the device kernels in tabcorr_tpu/ops/paircount.py).
//
// Conventions match the device kernels: ordered pairs (each unordered pair
// counted twice in auto mode), self-pairs excluded, minimum-image periodic
// separations. Exposed through ctypes (see tabcorr_tpu/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct CellList {
    // Cell-list over one tracer set: cells of size >= the search radius in
    // each periodic dimension, point data stored contiguously per cell.
    int nc[3];
    int reach[3];
    double cell_size[3];
    double period[3];
    std::vector<int64_t> cell_start;  // size ncells+1
    std::vector<double> px, py, pz;   // reordered positions
    std::vector<int32_t> label;       // reordered labels
    std::vector<int64_t> orig;        // original indices (self-exclusion)
    std::vector<double> weight;       // reordered weights

    int64_t ncells() const {
        return int64_t(nc[0]) * nc[1] * nc[2];
    }

    int cell_coord(double x, int d) const {
        int c = int(std::floor(x / cell_size[d]));
        if (c >= nc[d]) c = nc[d] - 1;
        if (c < 0) c = 0;
        return c;
    }

    int64_t cell_index(int cx, int cy, int cz) const {
        return (int64_t(cx) * nc[1] + cy) * nc[2] + cz;
    }

    void build(const double* pos, const int32_t* labels,
               const double* weights, int64_t n, const double* box,
               const double* rmax) {
        for (int d = 0; d < 3; d++) {
            period[d] = box[d];
            // Refinement factor 2 (the Corrfunc bin_refine default):
            // cells of ~rmax/2 with a +-2-cell neighbor walk enclose the
            // search ball much tighter than rmax-sized cells with +-1 —
            // the per-point cell-gap pruning in count_pairs drops the
            // far corners of the walk entirely.
            int c = rmax[d] > 0
                ? int(std::floor(2.0 * box[d] / rmax[d])) : 1;
            nc[d] = std::max(1, std::min(c, 256));
            cell_size[d] = box[d] / nc[d];
            // Cells each side needed to cover rmax from anywhere inside
            // the home cell.
            reach[d] = rmax[d] > 0
                ? int(std::ceil(rmax[d] / cell_size[d] - 1e-12)) : 0;
            reach[d] = std::min(reach[d], nc[d]);
        }
        int64_t m = ncells();
        std::vector<int64_t> count(m, 0);
        std::vector<int64_t> cell_of(n);
        for (int64_t i = 0; i < n; i++) {
            double x = std::fmod(pos[3 * i + 0], period[0]);
            double y = std::fmod(pos[3 * i + 1], period[1]);
            double z = std::fmod(pos[3 * i + 2], period[2]);
            if (x < 0) x += period[0];
            if (y < 0) y += period[1];
            if (z < 0) z += period[2];
            int64_t c = cell_index(cell_coord(x, 0), cell_coord(y, 1),
                                   cell_coord(z, 2));
            cell_of[i] = c;
            count[c]++;
        }
        cell_start.assign(m + 1, 0);
        for (int64_t c = 0; c < m; c++)
            cell_start[c + 1] = cell_start[c] + count[c];
        px.resize(n); py.resize(n); pz.resize(n);
        label.resize(n); orig.resize(n); weight.resize(n);
        std::vector<int64_t> cursor(cell_start.begin(),
                                    cell_start.end() - 1);
        for (int64_t i = 0; i < n; i++) {
            int64_t at = cursor[cell_of[i]]++;
            // Store positions WRAPPED into [0, period): both endpoints
            // wrapped makes every raw difference fall in (-P, P), so the
            // minimum image needs a single branchless half-period
            // correction in the vectorized filter loop (bit-identical to
            // the nearbyint form for in-box inputs).
            px[at] = wrap(pos[3 * i + 0], period[0]);
            py[at] = wrap(pos[3 * i + 1], period[1]);
            pz[at] = wrap(pos[3 * i + 2], period[2]);
            label[at] = labels ? labels[i] : 0;
            orig[at] = i;
            weight[at] = weights ? weights[i] : 1.0;
        }
    }

    static double wrap(double x, double p) {
        double w = std::fmod(x, p);
        if (w < 0) w += p;
        return w;
    }
};

// kind: 0 = rppi (rp bins, |dz| < pi_max), 1 = proj (rp bins, any dz),
//       2 = smu ((s, mu) bins).
void count_pairs(const double* pos1, const int32_t* labels1, int64_t n1,
                 const double* pos2, const int32_t* labels2,
                 const double* weights2, int64_t n2, int autocorr,
                 int n_labels_1, int n_labels_2, const double* r_edges_sq,
                 int n_r, double pi_max, int n_mu, const double* period,
                 int kind, int pair_weight, double* out) {
    double rmax[3];
    double r_max = std::sqrt(r_edges_sq[n_r]);
    if (kind == 2) {  // smu: isotropic search radius
        rmax[0] = rmax[1] = rmax[2] = r_max;
    } else {
        rmax[0] = rmax[1] = r_max;
        rmax[2] = (kind == 0) ? pi_max : 0.0;  // proj: full column
    }

    CellList grid;
    grid.build(pos2, labels2, weights2, n2, period, rmax);

    int n_sub = (kind == 2) ? n_r * n_mu : n_r;
    // pair_weight 2 ("unit+log_rp") writes two channels into a doubled
    // histogram: [0, n_hist) unit weights, [n_hist, 2 n_hist) w ln(rp) —
    // one pair enumeration instead of two for the delta-sigma estimator.
    int64_t n_hist = int64_t(n_labels_1) * n_labels_2 * n_sub;
    int64_t n_hist_total = (pair_weight == 2) ? 2 * n_hist : n_hist;

    int n_threads = 1;
#ifdef _OPENMP
    n_threads = omp_get_max_threads();
#endif
    std::vector<std::vector<double>> partial(
        n_threads, std::vector<double>(n_hist_total, 0.0));

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t i = 0; i < n1; i++) {
        int tid = 0;
#ifdef _OPENMP
        tid = omp_get_thread_num();
#endif
        double* hist = partial[tid].data();
        double x1 = pos1[3 * i + 0], y1 = pos1[3 * i + 1],
               z1 = pos1[3 * i + 2];
        int l1 = labels1 ? labels1[i] : 0;
        // Out-of-range labels are dropped like negatives (the device
        // twin's one-hot/scatter semantics); without the upper check an
        // over-range label would index past the histogram.
        if (l1 < 0 || l1 >= n_labels_1) continue;
        int64_t base1 = int64_t(l1) * n_labels_2;

        double xw = std::fmod(x1, period[0]);
        double yw = std::fmod(y1, period[1]);
        double zw = std::fmod(z1, period[2]);
        if (xw < 0) xw += period[0];
        if (yw < 0) yw += period[1];
        if (zw < 0) zw += period[2];
        int cx = grid.cell_coord(xw, 0);
        int cy = grid.cell_coord(yw, 1);
        int cz = grid.cell_coord(zw, 2);

        // Two-phase inner loop (the Corrfunc design, arXiv 1911.08275):
        // phase A is a branch-free SIMD sweep computing separations and a
        // cheap in-range predicate for a whole chunk of cell-contiguous
        // candidates; phase B is a scalar skim that bins and accumulates
        // only the survivors (a few-cycle mask test per rejected
        // candidate).  The single half-period correction relies on the
        // cell list storing wrapped coordinates (see CellList::build).
        constexpr int CHUNK = 256;
        double buf_rp[CHUNK], buf_dz[CHUNK];
        double buf_v[CHUNK], buf_rp2[CHUNK], buf_dz2[CHUNK];
        uint8_t buf_ok[CHUNK];
        int16_t buf_idx[CHUNK];
        int32_t buf_bin[CHUNK];
        const double p0 = period[0], p1 = period[1], p2 = period[2];
        const double h0 = 0.5 * p0, h1 = 0.5 * p1, h2 = 0.5 * p2;
        const double e_lo = r_edges_sq[0], e_hi = r_edges_sq[n_r];
        // Loop-invariant knobs folded into arithmetic so the filter loop
        // body is branch-free (short-circuit && / invariant ifs block
        // auto-vectorization): kind 2 ranges on s^2 = rp^2 + dz^2, kind 0
        // adds the finite pi cut, kind 1 spans any dz.
        const double smu_w = (kind == 2) ? 1.0 : 0.0;
        const double z_cut = (kind == 0) ? pi_max
            : std::numeric_limits<double>::infinity();
        const double* __restrict pxp = grid.px.data();
        const double* __restrict pyp = grid.py.data();
        const double* __restrict pzp = grid.pz.data();

        auto visit = [&](int gx, int gy, int gz) {
            int64_t c = grid.cell_index(gx, gy, gz);
            int64_t c_end = grid.cell_start[c + 1];
            for (int64_t j0 = grid.cell_start[c]; j0 < c_end;
                 j0 += CHUNK) {
                int m = int(std::min<int64_t>(CHUNK, c_end - j0));
#ifdef _OPENMP
#pragma omp simd
#endif
                for (int k = 0; k < m; k++) {
                    double dx = xw - pxp[j0 + k];
                    double dy = yw - pyp[j0 + k];
                    double dz = zw - pzp[j0 + k];
                    dx += p0 * (double((dx < -h0)) - double((dx > h0)));
                    dy += p1 * (double((dy < -h1)) - double((dy > h1)));
                    dz += p2 * (double((dz < -h2)) - double((dz > h2)));
                    double rp_sq = dx * dx + dy * dy;
                    dz = std::fabs(dz);
                    buf_rp[k] = rp_sq;
                    buf_dz[k] = dz;
                    double range_sq = rp_sq + smu_w * (dz * dz);
                    buf_ok[k] = uint8_t(int(range_sq >= e_lo) &
                                        int(range_sq < e_hi) &
                                        int(dz < z_cut));
                }
                // Branchless survivor compaction (an if-skim on a ~20%
                // hit rate mispredicts constantly; unconditional stores
                // with a conditional advance do not), gathering the
                // binning operands contiguously for the SIMD passes.
                int n_surv = 0;
                for (int k = 0; k < m; k++) {
                    buf_idx[n_surv] = int16_t(k);
                    buf_v[n_surv] = buf_rp[k] +
                        smu_w * (buf_dz[k] * buf_dz[k]);
                    buf_rp2[n_surv] = buf_rp[k];
                    buf_dz2[n_surv] = buf_dz[k];
                    n_surv += int(buf_ok[k]);
                }
                // SIMD binning: phase A guarantees e_lo <= v < e_hi, so
                // the radial bin is exactly the count of interior edges
                // <= v.  Edge-outer / survivor-inner keeps the inner
                // body a single vectorizable compare-accumulate.
                std::memset(buf_bin, 0, n_surv * sizeof(int32_t));
                for (int kk = 1; kk < n_r; kk++) {
                    const double ek = r_edges_sq[kk];
#ifdef _OPENMP
#pragma omp simd
#endif
                    for (int s = 0; s < n_surv; s++)
                        buf_bin[s] += int32_t(buf_v[s] >= ek);
                }
                if (kind == 2) {
#ifdef _OPENMP
#pragma omp simd
#endif
                    for (int s = 0; s < n_surv; s++) {
                        // A zero-separation pair (possible only when the
                        // s bins start at 0) is dropped like the scalar
                        // code did: bin -1, skipped in accumulation.
                        int nz_ok = int(buf_v[s] > 0.0);
                        double mu = buf_dz2[s] /
                            std::sqrt(buf_v[s] + double(1 - nz_ok));
                        int mb = int(mu * n_mu);
                        mb = mb < n_mu - 1 ? mb : n_mu - 1;
                        buf_bin[s] = nz_ok ?
                            buf_bin[s] * n_mu + mb : -1;
                    }
                }
                for (int s = 0; s < n_surv; s++) {
                    int64_t j = j0 + buf_idx[s];
                    if (autocorr && grid.orig[j] == i) continue;
                    int l2 = grid.label[j];
                    if (l2 < 0 || l2 >= n_labels_2 ||
                        buf_bin[s] < 0) continue;
                    double w = grid.weight[j];
                    int64_t idx = (base1 + l2) * n_sub + buf_bin[s];
                    // pair_weight 1: accumulate w * ln(rp) for the exact
                    // annulus-averaged delta-sigma estimator (rp floored
                    // so a coincident pair stays finite); 2: both
                    // channels in one pass.
                    if (pair_weight == 2) {
                        hist[idx] += w;
                        hist[n_hist + idx] +=
                            w * 0.5 * std::log(std::max(buf_rp2[s], 1e-20));
                    } else {
                        if (pair_weight == 1)
                            w *= 0.5 * std::log(std::max(buf_rp2[s], 1e-20));
                        hist[idx] += w;
                    }
                }
            }
        };

        // Distinct wrapped neighbor cells per dimension, each with the
        // minimum periodic distance ("gap") from THIS point to that
        // cell's interval — the triple loop below prunes whole cells
        // whose combined gap already exceeds the search range.
        struct Nb { int cell; double gap; };
        Nb nbx[8], nby[8], nbz[8];
        int nx = 0, ny = 0, nz = 0;
        auto collect = [&](double xq, int cq, int d, Nb* out,
                           int& n_out) {
            double cs = grid.cell_size[d], p = grid.period[d];
            for (int o = -grid.reach[d]; o <= grid.reach[d]; o++) {
                int g = cq + o;
                while (g < 0) g += grid.nc[d];
                while (g >= grid.nc[d]) g -= grid.nc[d];
                bool dup = false;
                for (int k = 0; k < n_out; k++)
                    if (out[k].cell == g) dup = true;
                if (dup) continue;
                double lo = g * cs, hi = lo + cs;
                // Distance from xq to [lo, hi], minimized over periodic
                // images of the point.
                auto gap_at = [&](double x) {
                    return std::max({0.0, lo - x, x - hi});
                };
                double gap = std::min({gap_at(xq), gap_at(xq + p),
                                       gap_at(xq - p)});
                out[n_out++] = {g, gap};
            }
        };
        collect(xw, cx, 0, nbx, nx);
        collect(yw, cy, 1, nby, ny);
        // kind 'proj' builds a single full-height z cell (rmax_z = 0), so
        // the same neighbor walk covers the whole column (gap unused).
        collect(zw, cz, 2, nbz, nz);

        const double r_hi = r_edges_sq[n_r];
        for (int a = 0; a < nx; a++)
            for (int b = 0; b < ny; b++) {
                double rp_gap_sq = nbx[a].gap * nbx[a].gap +
                                   nby[b].gap * nby[b].gap;
                if (rp_gap_sq >= r_hi && kind != 2) continue;
                for (int g = 0; g < nz; g++) {
                    double gz = nbz[g].gap;
                    if (kind == 2) {
                        if (rp_gap_sq + gz * gz >= r_hi) continue;
                    } else if (kind == 0 && gz >= pi_max) {
                        continue;
                    }
                    visit(nbx[a].cell, nby[b].cell, nbz[g].cell);
                }
            }
    }

    std::memset(out, 0, sizeof(double) * n_hist_total);
    for (int t = 0; t < n_threads; t++)
        for (int64_t h = 0; h < n_hist_total; h++)
            out[h] += partial[t][h];
}

}  // namespace

extern "C" {

// Labeled pair counts; out has n_labels_1 * n_labels_2 * n_r doubles
// ('rppi'/'proj') or * n_r * n_mu ('smu': kind=2); pair_weight 2 doubles
// the out length (unit channel then w*ln(rp) channel).
void tabcorr_count_pairs(const double* pos1, const int32_t* labels1,
                         int64_t n1, const double* pos2,
                         const int32_t* labels2, const double* weights2,
                         int64_t n2, int autocorr, int n_labels_1,
                         int n_labels_2, const double* r_edges_sq, int n_r,
                         double pi_max, int n_mu, const double* period,
                         int kind, int pair_weight, double* out) {
    count_pairs(pos1, labels1, n1, pos2, labels2, weights2, n2, autocorr,
                n_labels_1, n_labels_2, r_edges_sq, n_r, pi_max, n_mu,
                period, kind, pair_weight, out);
}

int tabcorr_native_version() { return 3; }

}  // extern "C"
