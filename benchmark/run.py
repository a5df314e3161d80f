"""The benchmark of tabcorr_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
It sets up the cell (tables, the port's predictor, the walkers, all from
the seed), warms every shape the window uses, runs the port's stretch-move
sampler back to back for ``--seconds``, then checks what the window
produced against the plain reference and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy time and a breakdown.  The numbers
compared are printed last on standard error and last in the line
(``checks``), each beside its limit.

Without a card (or with fewer than the cell asks for), or outside a
checkout that holds the port, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_age_s():
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()
BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

FORBIDDEN = ("jax", "jaxlib", "flax", "tabcorr_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``tabcorr_tpu_torch`` is not ``tabcorr_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} &
                  set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def run(args, device, control=None, predictor_wrap=None, step_wrap=None,
        age=None, walkers=None):
    """One run; returns ``(line, checks)``: the result's dict, and the
    numbers compared as ``[(name, value, limit), ...]``.  ``walkers``
    shrinks the ensemble (the CPU tests only)."""
    import torch

    from benchlib import cell as cells
    from benchlib.manifest import Manifest
    from benchlib.trace import Tracer

    age = age or process_age_s
    phases = {"imported": age()}
    cell = Manifest().cell(args.workload)
    if walkers is not None:
        cell.traffic["walkers"] = walkers
    device = torch.device(device)
    cr = cells.CellRun(cell, args.seed, device, control=control,
                       predictor_wrap=predictor_wrap, step_wrap=step_wrap)
    phases["built"] = age()
    tracer = Tracer(device) if args.trace else None
    cr.setup(tracer)
    setup_s = age()
    win, run_ = cr.measure(args.seconds, tracer)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the measured process: {found}")
    attempted, failed = cells.attempted_failed(win)
    line = {"correct": False, "attempted": attempted, "failed": failed}
    e2e = cells.end_to_end(cr, win, setup_s)
    if args.trace:
        values = cells.per_layer(cell, run_)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    line["metrics"] = {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()}
    line["device"] = device_info(torch, device, cr.memory_peak)
    if args.trace:
        line["device"].update(cells.device_trace(run_))
        line["breakdown"] = cells.breakdown(run_)
    line["setup_phases_s"] = dict(phases, warm=setup_s)
    line["steps"] = win.steps
    line["launches_per_step"] = cr.launches_per_step
    t0 = time.perf_counter()
    numbers = cr.compare()
    line["check_s"] = time.perf_counter() - t0
    correct, checks = cr.judge.verdict(numbers)
    line["correct"] = bool(correct and failed == 0)
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line, checks


def main(argv=None):
    args = parse(argv)
    import torch

    from benchlib.manifest import Manifest

    chips = Manifest().cell(args.workload).chips
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    line, checks = run(args, "cuda")
    for name, value, limit in checks:
        print(f"check {name} {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
