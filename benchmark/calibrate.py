"""Readings of the numbers ``correct`` compares, for setting their limits.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        [--control none|bf16|tf32] --seeds <n> [<n> ...]

runs the cell once a seed in one process (set-up, a short window at the
cell's own size, the comparison) and prints one JSON line a seed with
every number compared.  ``--fault`` plants one of ``benchlib.faults``
under the timed path.  ``--control`` puts a lower precision in the
program's place: ``bf16`` the port's bfloat16 route, ``tf32`` the plain
reference in float32 with TF32 products.  A sound run's readings give a
limit's lower end, the controls' its upper end (PERF.md keeps both).
Needs the cell's CUDA device, like ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", choices=("none", "bf16", "tf32"),
                   default="none")
    p.add_argument("--fault", choices=("none", "stale", "half", "alter"),
                   default="none")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from benchlib import faults
    control = None if args.control == "none" else args.control
    for seed in args.seeds:
        t0 = time.perf_counter()
        line, _ = run.run(run.parse(
            ["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", "0"]), "cuda", control=control,
            predictor_wrap=faults.PREDICTOR.get(args.fault),
            step_wrap=faults.STEP.get(args.fault), age=lambda: 0.0)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": args.control,
            "fault": args.fault,
            "correct": line["correct"], "steps": line["steps"],
            "seconds": time.perf_counter() - t0,
            "numbers": {k: v["value"] for k, v in line["checks"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
