"""Read the CUDA pair counter on one card at the tabulation's sizes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/torch_paircount_probe.py [--hist-kb 16,40,96] [--repeat 2]

It builds the sweeps of chip_smoke.py's tabulation phase -- wp and
xi(s, mu) in the 'default' configuration and Delta Sigma in the
'efficient' one, on 200,000 synthetic hosts in a 250 Mpc/h box (Delta
Sigma against 1,000,000 particles), and wp on the clustered catalog with
``--clustered`` -- by running ``TabCorr.tabulate`` on the card up to its
sweep.  For each sweep, each label-group histogram budget of
``--hist-kb`` (``ops.paircount.HIST_BYTES``; a budget that changes no
group is skipped) and each ``--cells-per-reach`` (``CELLS_PER_REACH``,
xy cells across the largest radial edge; with ``--no-chord``, xi(s, mu)
also with every z reach at the largest s) it prints the layout (cells,
neighbour cells, label groups, tiles), the pairs the kernel evaluates,
the kept pairs and the kernel's time by CUDA events (each of
``--repeat`` launches), and holds every setting's histogram equal to the
first's (unit counts equal, weighted cells within 1e-7).
"""

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import tabcorr_tpu_torch as tp  # noqa: E402
from tabcorr_tpu_torch.ops import paircount as pc  # noqa: E402
from tabcorr_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_halocat, synthetic_particles)

SEED = 7


class _Captured(Exception):
    pass


def capture_sweeps(clustered):
    """The tabulation sweeps of chip_smoke.py's tabulation phase, each
    caught at its call of ``paircount`` on the card."""
    halocat = synthetic_halocat(200_000, 250.0)
    particles = synthetic_particles(1_000_000, halocat)
    default = tp.database.configuration("default")
    efficient = tp.database.configuration("efficient")
    common = dict(mode="auto", prim_haloprop_bins=30,
                  sec_haloprop_percentile_bins=0.5,
                  sats_per_prim_haloprop=default["sats_per_prim_haloprop"],
                  redshift_space_distortions=True, project_xyz=False,
                  cosmology_obs=default["cosmo_obs"], seed=SEED,
                  device="cuda")
    runs = {
        "wp": lambda cat: tp.TabCorr.tabulate(
            cat, tp.corrfunc.wp, default["rp_wp_bins"], default["pi_max"],
            **common),
        "s_mu": lambda cat: tp.TabCorr.tabulate(
            cat, tp.corrfunc.s_mu_tpcf, default["s_bins"],
            default["mu_bins"], **common),
        "ds": lambda cat: tp.TabCorr.tabulate(
            cat, tp.corrfunc.mean_delta_sigma, particles.positions,
            particles.effective_particle_mass, efficient["rp_ds_bins"],
            **{**common, "mode": "cross", "prim_haloprop_bins": 300,
               "sec_haloprop_percentile_bins": None, "cosmology_obs": None,
               "sats_per_prim_haloprop":
                   efficient["sats_per_prim_haloprop"],
               "downsample": efficient["downsample"]}),
    }
    catalogs = {"wp": halocat, "s_mu": halocat, "ds": halocat}
    if clustered:
        runs["wp clustered"] = runs["wp"]
        catalogs["wp clustered"] = synthetic_halocat(200_000, 250.0,
                                                     clumps=4000)
    sweeps = {}
    dispatch = pc.paircount

    def catch(sweep, **_):      # the sweep alone; progress= is not kept
        sweeps[label] = sweep
        raise _Captured

    pc.paircount = catch
    try:
        for label, run in runs.items():
            try:
                run(catalogs[label])
            except _Captured:
                pass
    finally:
        pc.paircount = dispatch
    return sweeps


def time_launch(sweep, layout):
    """(histogram, pairs evaluated, kernel ms by CUDA events)."""
    visited = torch.zeros(1, dtype=torch.int64, device=sweep.device)
    events = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
    hist = pc.paircount_launch(sweep, layout, visited, events)
    torch.cuda.synchronize()
    return hist, int(visited), events[0].elapsed_time(events[1])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hist-kb", default="40",
                        help="comma-separated label-group histogram "
                             "budgets, KB")
    parser.add_argument("--cells-per-reach", default="4",
                        help="comma-separated CELLS_PER_REACH values")
    parser.add_argument("--repeat", type=int, default=2)
    parser.add_argument("--clustered", action="store_true")
    parser.add_argument("--no-chord", action="store_true",
                        help="also time xi(s, mu) with every offset's z "
                             "reach at s_max (no half-chord)")
    parser.add_argument("--only", default=None,
                        help="comma-separated sweeps (wp, s_mu, ds, "
                             "'wp clustered')")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    pc.load_kernels()
    defaults = pc.CELLS_PER_REACH, pc.HIST_BYTES
    sweeps = capture_sweeps(args.clustered)
    only = args.only.split(",") if args.only else list(sweeps)
    settings = [(int(k), float(kb), False)
                for k in args.cells_per_reach.split(",")
                for kb in args.hist_kb.split(",")]
    if args.no_chord:
        settings += [(k, kb, True) for k, kb, _ in settings]
    z_reach = pc._z_reach

    def flat_reach(sweep, gaps):
        """Every offset's z reach at the largest s: no half-chord."""
        return z_reach(sweep, gaps * 0.0)
    for label in only:
        sweep = sweeps[label]
        kept = None
        seen = set()
        first = None
        for k, kb, flat in settings:
            if flat and sweep.kind != "smu":
                continue
            pc.CELLS_PER_REACH, pc.HIST_BYTES = k, int(kb * 1024)
            pc._z_reach = flat_reach if flat else z_reach
            layout = pc.bucket_layout(sweep)
            pc._z_reach = z_reach
            groups = (k, flat, tuple(layout.group_start.tolist()))
            if groups in seen:
                continue
            seen.add(groups)
            times = []
            for _ in range(args.repeat):
                hist, visited, kernel_ms = time_launch(sweep, layout)
                times.append(kernel_ms)
            if first is None:
                first = hist
                kept = int(hist[:sweep.n_hist].sum()) if sweep.unit_counts \
                    else None
            elif sweep.unit_counts:
                assert torch.equal(hist, first), f"{label}: {kb} KB differs"
            else:
                scale = float(first.abs().max())
                assert bool(((hist - first).abs() <= 1e-7 * first.abs() +
                             1e-7 * scale).all()), f"{label}: {kb} KB differs"
            rows = ("private rows" if layout.private_rows else
                    f"{len(groups[2]) - 1} groups of <= {layout.group_rows}")
            print(f"{label}: {k} cells per reach"
                  f"{', no half-chord' if flat else ''}, hist {kb:g} KB -> "
                  f"{rows}, "
                  f"{layout.cells[0]} x {layout.cells[1]} cells, "
                  f"{len(layout.neighbours)} neighbour cells, "
                  f"{layout.n_tiles} tiles x {sweep.n_labels_2} j-labels; "
                  f"{visited} candidates"
                  f"{f', {kept} kept' if kept is not None else ''}; kernel "
                  f"ms {[round(t, 2) for t in times]}", flush=True)
        pc.CELLS_PER_REACH, pc.HIST_BYTES = defaults
    return 0


if __name__ == "__main__":
    sys.exit(main())
