"""Read the CUDA occupation kernel of the HOD families on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/torch_occupation_probe.py

For every family case of the CUDA tests (tests/test_torch_kernel.py,
``OCCUPATION_KINDS``: Leauthaud11, ZuMandelbaum15, Tinker13, Cacciato09
and their decorations) on the bolplanck wp table at 4,133 rows it prints
the occupation kernel's densities against the plain version (as a
fraction of tabcorr_tpu's fused-against-XLA bar, 1e-4 relative + 2e-6 of
the row's largest density) and, with the plain float32 version beside
it, against the float64 tensor path (relative, floored at 1e-6 of the
row's largest); then the kernel's and the plain version's times at
262,144 rows on wp, and the kernel's on the 'efficient' Delta Sigma grid
(1104 bins, 2,800 distinct of 11,040 (bin, node) abscissae), CUDA events.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

import test_torch_kernel as cases  # noqa: E402
from tabcorr_tpu_torch import Interpolator, TabCorr  # noqa: E402
from tabcorr_tpu_torch.ops import fused  # noqa: E402
from tabcorr_tpu_torch.predictor import stacked_grid  # noqa: E402

BATCH = 262144


def ms(fn, n_iter=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fused.load_kernels()
    cuda = torch.device("cuda", 0)
    tab = TabCorr.read(cases.DATA / "bolplanck_wp.npz")
    table = tab.table_data(device=cuda)
    table64 = tab.table_data(device=cuda, dtype=torch.float64)
    c = fused.slab_tc_table_constants(table, 1)
    for kind in cases.OCCUPATION_KINDS:
        model = cases._occupation_model(kind)
        fam = fused.OccupationFamily.of(model)
        params = cases._occupation_params(model, 4096 + 37, 11, cuda)
        rows, = fused.occupation_launch(c.occupation_plan, fam,
                                        fused.family_columns(params, fam),
                                        bin_major=False)
        plain = fused.occupation_density(table, model, params)
        want64 = fused.occupation_density(
            table64, model, {k: v.double() for k, v in params.items()})
        d = (rows.double() - plain.double()).abs()
        bar = 1e-4 * plain.double().abs() + 2e-6 * plain.double().abs(
        ).amax(1, keepdim=True)
        print(f"{kind}: kernel against plain {float((d / bar).max()):.3e} "
              f"of the bar; against float64 kernel "
              f"{cases._density_errors(rows, want64):.3e}, plain "
              f"{cases._density_errors(plain, want64):.3e}")
    for kind in ("leauthaud11", "zu15", "tinker13 quiescent", "cacciato09",
                 "assembias_leauthaud11"):
        model = cases._occupation_model(kind)
        fam = fused.OccupationFamily.of(model)
        params = cases._occupation_params(model, BATCH, 3, cuda)
        cols = fused.family_columns(params, fam)
        k_ms = ms(lambda: fused.occupation_launch(c.occupation_plan, fam,
                                                  cols))
        p_ms = ms(lambda: fused.occupation_density(table, model, params), 1)
        print(f"timing wp {kind}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
              f"ms ({BATCH} rows)")
    stacked, n_nodes, _ = stacked_grid(
        Interpolator.read(cases.DATA / "ds_efficient.npz"), device=cuda)
    plan = fused.grid_table_constants(stacked, n_nodes).occupation_plan
    model = cases.AssembiasLeauthaud11Model(threshold=10.5, redshift=0.5)
    fam = fused.OccupationFamily.of(model)
    cols = fused.family_columns(
        cases._occupation_params(model, BATCH, 3, cuda), fam)
    k_ms = ms(lambda: fused.occupation_launch(plan, fam, cols))
    print(f"timing ds_efficient assembias_leauthaud11: kernel {k_ms:.3f} ms "
          f"({BATCH} rows, {plan.n_distinct} of {plan.n_evaluated} (bin, "
          f"node) abscissae distinct)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
