"""Time the kernels this tree shares with an earlier one, in turns.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/torch_parent_turns.py --parent DIR [--rounds 3]

DIR holds an earlier tree's ``tabcorr_tpu_torch/csrc`` (for example
``git archive <commit> tabcorr_tpu_torch/csrc | tar -x -C build/parent``).
The libraries whose C entry points both trees share (bundle, grid,
occupation, paircount, and slab's FP32 entry point) are built from both
trees at once, one nvcc each.  Each kernel is then launched through this
tree's wrapper with either library bound, on the inputs chip_smoke.py's
main paths give it (caught at the wrapper by running the same predictors
and tabulations once): bundle and contraction on the bench tables at
262,144 rows, grid on the 64-node grid, slab on the wide grid
at 32,768 rows, the occupation kernel on the 'efficient' Delta Sigma grid
for AssembiasLeauthaud11, the pair counter on the wp, xi(s, mu) and Delta
Sigma sweeps and on chip_smoke's 65,536-tracer wp subsample.  The
bfloat16 contraction (bf16.cu), whose C entry point changed with its
wgmma redesign, is timed on path 12's six inputs (the bf16 route's
densities of wp, xi_ell, Delta Sigma, the 64-node grid, ds 'efficient'
and the wide grid) where the parent's bf16.cu differs from this tree's:
this tree's through its wrapper, the parent's mma.sync kernel through
its own layout (the zero-padded (n_xi ni, kp) matrix, kp the bins
rounded up to 16, ni to 8) and launch arithmetic; the two results are
compared in bfloat16 ulps.  Times are
CUDA-event windows in turns (parent, this tree, this tree, parent, for
``--rounds`` rounds), each kernel's median printed beside the card's name
and power limit.  It also prints which source files differ between the
trees and, per library, whether each kernel's SASS is the same in both.
A JSON summary goes to build/parent_turns/parent_turns.json.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tabcorr_tpu_torch import (AssembiasLeauthaud11Model,  # noqa: E402
                               AssembiasZheng07Model, Interpolator, TabCorr,
                               Zheng07Model, make_multi_predictor,
                               make_predictor)
from tabcorr_tpu_torch.ops import fused  # noqa: E402
from tabcorr_tpu_torch.predictor import stacked_grid  # noqa: E402
from tabcorr_tpu_torch.ops import paircount as pc  # noqa: E402
from tabcorr_tpu_torch.utils import build  # noqa: E402
from tabcorr_tpu_torch.utils.synthetic import (  # noqa: E402
    grid64_interpolator, wide_grid_interpolator)

OUT = ROOT / "build" / "parent_turns"
DATA = ROOT / "tabcorr_tpu_torch" / "data"
# library -> (module, its cached binder)
LIBRARIES = {"bundle": (fused, "_bundle_lib"), "grid": (fused, "_grid_lib"),
             "occupation": (fused, "_occupation_lib"),
             "slab": (fused, "_slab_lib"),
             "paircount": (pc, "_paircount_lib")}
SOURCES = {**fused.KERNEL_SOURCES, **pc.KERNEL_SOURCES}
# wrapper -> (module, library)
WRAPPERS = {"bundle_launch": (fused, "bundle"),
            "contraction_launch": (fused, "bundle"),
            "grid_launch": (fused, "grid"),
            "occupation_launch": (fused, "occupation"),
            "slab_launch": (fused, "slab"),
            "paircount_launch": (pc, "paircount")}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_parent(csrc):
    """Each library of SOURCES built from ``csrc`` into OUT, all at once."""
    procs = {}
    for name, sources in SOURCES.items():
        lib = OUT / f"lib{name}-parent.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
               *(str(csrc / s) for s in sources)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        libs[name] = lib
    return libs


def bind(name, path):
    """The library at ``path`` bound as this tree binds library ``name``."""
    module, binder = LIBRARIES[name]
    load = module.load_library
    module.load_library = lambda *_: ctypes.CDLL(str(path))
    try:
        return getattr(module, binder).__wrapped__()
    finally:
        module.load_library = load


def sass_functions(path):
    """{kernel name: its SASS} of a library, anonymous namespaces named
    alike in both trees."""
    text = subprocess.run(
        [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(path)], capture_output=True, text=True, check=True).stdout
    text = strip_anonymous(text)
    out = {}
    for func in re.split(r"\n\s+Function : ", text)[1:]:
        name, body = func.split("\n", 1)
        out[name.strip()] = body
    return out


def strip_anonymous(text):
    """``text`` with every ``<length>_GLOBAL__N_<rest>`` (the mangled name
    of an anonymous namespace, which hashes the source's path) replaced by
    ``ANON``."""
    out, pos = [], 0
    for m in re.finditer(r"(\d+)_GLOBAL__N_", text):
        if m.start() < pos:
            continue
        out.append(text[pos:m.start()] + "ANON")
        pos = m.start(1) + len(m[1]) + int(m[1])
    return "".join(out) + text[pos:]


def grid_params(model, rng, batch):
    """chip_smoke.py's grid parameters: its bench draws, with alpha_c,
    alpha_s and log_eta drawn over the grid."""
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    params = cs.bench_params(model, rng, batch, "cuda")
    for key, lo, hi in (("alpha_c", 0.05, 0.35), ("alpha_s", 0.85, 1.15),
                        ("log_eta", -0.3, 0.3)):
        params[key] = torch.tensor(rng.uniform(lo, hi, batch),
                                   dtype=torch.float32, device="cuda")
    return params


def changed_sources(parent_csrc):
    here = ROOT / "tabcorr_tpu_torch" / "csrc"
    names = sorted({p.name for p in here.iterdir()} |
                   {p.name for p in parent_csrc.iterdir()})
    return [n for n in names
            if not ((here / n).exists() and (parent_csrc / n).exists() and
                    (here / n).read_bytes() == (parent_csrc / n).read_bytes())]


def capture_inputs():
    """{label: (wrapper name, args, kwargs, launches a window)}: the
    arguments chip_smoke.py's main paths give each wrapper."""
    seen = {}
    originals = {w: getattr(m, w) for w, (m, _) in WRAPPERS.items()}

    def spy(wrapper):
        def run(*args, **kwargs):
            seen.setdefault(wrapper, (args, kwargs))
            return originals[wrapper](*args, **kwargs)
        return run

    def caught(wrapper):
        return seen.pop(wrapper)

    cases = {}
    for w, (m, _) in WRAPPERS.items():
        setattr(m, w, spy(w))
    try:
        rng = np.random.default_rng(cs.SEED)
        wp_tab = TabCorr.read(DATA / "bolplanck_wp.npz")
        xi_tab = TabCorr.read(DATA / "synthetic_xi_ell.npz")
        model = Zheng07Model(threshold=-18, redshift=wp_tab.attrs["redshift"])
        params = cs.bench_params(model, rng, cs.BATCH, "cuda")
        make_multi_predictor([wp_tab, xi_tab], model, device="cuda",
                             accuracy=("elementwise", "scaled"))(params)
        cases["bundle (wp + xi_ell)"] = (
            "bundle_launch", *caught("bundle_launch"), 3)
        make_predictor(xi_tab, model, engine="fused", device="cuda")(params)
        cases["contraction (xi_ell)"] = (
            "contraction_launch", *caught("contraction_launch"), 3)

        model = Zheng07Model(threshold=-20, redshift=0.0)
        params = grid_params(model, rng, cs.BATCH)
        make_predictor(grid64_interpolator(), model, engine="fused",
                       accuracy="scaled", device="cuda")(params)
        cases["grid (grid64)"] = ("grid_launch", *caught("grid_launch"), 1)

        model = AssembiasZheng07Model(threshold=-20, redshift=0.0)
        params = grid_params(model, rng, cs.SLAB_BATCH)
        make_predictor(wide_grid_interpolator(), model, engine="fused",
                       accuracy="elementwise", device="cuda")(params)
        cases["slab (wide grid)"] = ("slab_launch", *caught("slab_launch"), 1)

        model = AssembiasLeauthaud11Model(threshold=10.5, redshift=0.5,
                                          prim_haloprop_key="halo_m258m")
        model.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
        params = cs.family_params(model, rng, cs.BATCH)
        params["log_eta"] = torch.tensor(
            rng.uniform(-0.45, 0.45, cs.BATCH), dtype=torch.float32,
            device="cuda")
        make_predictor(Interpolator.read(DATA / "ds_efficient.npz"), model,
                       engine="fused", accuracy="scaled",
                       device="cuda")(params)
        cases["occupation (ds_efficient, AssembiasLeauthaud11)"] = (
            "occupation_launch", *caught("occupation_launch"), 1)
    finally:
        for w, (m, _) in WRAPPERS.items():
            setattr(m, w, originals[w])
    torch.cuda.synchronize()

    from torch_paircount_probe import capture_sweeps
    sweeps = capture_sweeps(clustered=False)
    for label, sweep in sweeps.items():
        cases[f"paircount ({label} sweep)"] = (
            "paircount_launch", (sweep,),
            {"layout": pc.bucket_layout(sweep)}, 1)
    sub = cs.subsample({"torch": torch}, sweeps["wp"], cs.TAB_SUBSAMPLE,
                       cs.SEED + 91)
    cases[f"paircount ({cs.TAB_SUBSAMPLE} tracers of wp)"] = (
        "paircount_launch", (sub,), {"layout": pc.bucket_layout(sub)}, 5)
    return cases


def bf16_cases():
    """{label: (this tree's constants, the parent's layout, densities)} on
    chip_smoke.py's path 12 inputs."""
    bf16 = torch.bfloat16
    cases = {}
    for name, obj, model, params, _, _ in cs.bf16_cases(
            {"torch": torch, "np": np}):
        table = (obj.table_data(dtype=bf16, device="cuda")
                 if isinstance(obj, TabCorr) else
                 stacked_grid(obj, device="cuda", dtype=bf16)[0])
        dense, nb = table.tpcf_dense, table.n_bins
        n_xi, auto = dense.shape[0], table.mode == "auto"
        kp = -(-nb // 16) * 16
        if auto:
            ni = -(-nb // 8) * 8
            bt = dense.new_zeros((n_xi, ni, kp))
            bt[:, :nb, :nb] = dense
            bt = bt.reshape(n_xi * ni, kp)
        else:
            ni = 0
            bt = dense.new_zeros((-(-n_xi // 8) * 8, kp))
            bt[:n_xi, :nb] = dense
        parent = dict(bt=bt.contiguous(), kp=kp, ni=ni, n_xi=n_xi,
                      auto=auto, nb=nb)
        cases[f"contraction_bf16 ({name})"] = (
            fused.bf16_table_constants(table), parent,
            fused.bf16_densities(table, model, params))
        torch.cuda.synchronize()
    return cases


def bind_parent_bf16(path):
    """The parent's bf16 library: tabcorr_contraction_bf16(ngal, batch,
    nb, kp, bt, n_xi, ni, is_auto, units_per_block, total, xi, device,
    stream)."""
    lib = ctypes.CDLL(str(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tabcorr_contraction_bf16.argtypes = ([vp] + [i] * 3 + [vp] +
                                             [i] * 4 + [vp, vp, i, vp])
    lib.tabcorr_contraction_bf16.restype = i
    return lib


def parent_bf16_launch(lib, lay, ngal):
    """The parent's wrapper: 128-row blocks up to 160 padded bins, else
    64; the grid's second dimension splits the statistics (auto) or
    8-column tiles (cross) so that a launch has ~1056 blocks."""
    batch = ngal.shape[0]
    total = torch.empty(batch, device="cuda", dtype=torch.bfloat16)
    xi = torch.empty((batch, lay["n_xi"]), device="cuda",
                     dtype=torch.bfloat16)
    units = lay["n_xi"] if lay["auto"] else -(-lay["n_xi"] // 8)
    row_blocks = max(1, -(-batch // (128 if lay["kp"] <= 160 else 64)))
    split = min(units, max(-(-1056 // row_blocks), -(-units // 65535)))
    code = lib.tabcorr_contraction_bf16(
        ngal.data_ptr(), batch, lay["nb"], lay["kp"], lay["bt"].data_ptr(),
        lay["n_xi"], lay["ni"], int(lay["auto"]), -(-units // split),
        total.data_ptr(), xi.data_ptr(), *fused._stream_args(ngal.device))
    if code != 0:
        raise RuntimeError(f"the parent's bf16 kernel failed: {code}")
    return total, xi


def max_ulps(a, b):
    """Largest |a - b| in bfloat16 ulps of the larger of the two."""
    a, b = a.double(), b.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a),
                                              e - 8)).max())


def window_ms(fn, n_iter):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device.", file=sys.stderr)
        return 1
    name = card()
    print(f"card (name, power limit): {name}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    parent_csrc = args.parent / "tabcorr_tpu_torch" / "csrc"
    changed = changed_sources(parent_csrc)
    print(f"csrc files that differ from the parent's: {changed}")
    fused.load_kernels()
    pc.load_kernels()
    parent_paths = build_parent(parent_csrc)
    libs = {"change": {n: getattr(m, b)() for n, (m, b) in LIBRARIES.items()},
            "parent": {n: bind(n, p) for n, p in parent_paths.items()
                       if n in LIBRARIES}}
    parent_bf16 = (bind_parent_bf16(parent_paths["bf16"])
                   if "bf16.cu" in changed else None)
    summary = {"card": name, "changed": changed, "sass": {}, "ms": {}}
    for lib_name, path in parent_paths.items():
        mine = sass_functions(build.library_path(lib_name))
        theirs = sass_functions(path)
        same = sorted(k for k in mine if theirs.get(k) == mine[k])
        differ = sorted(k for k in mine if k in theirs and
                        theirs[k] != mine[k])
        summary["sass"][lib_name] = {"same": len(same), "differ": differ,
                                     "only here": len(set(mine) -
                                                      set(theirs))}
        print(f"SASS of {lib_name}: {len(same)} kernels the same in both "
              f"trees, differing: {differ}, {len(set(mine) - set(theirs))} "
              f"only in this tree", flush=True)

    cases = capture_inputs()
    print(f"inputs caught for {len(cases)} cases", flush=True)

    def runner(case, tree):
        wrapper, call_args, call_kwargs, _ = case
        module, lib_name = WRAPPERS[wrapper]
        _, binder = LIBRARIES[lib_name]
        fn = getattr(module, wrapper)
        lib = libs[tree][lib_name]

        def run():
            cached = getattr(module, binder)
            setattr(module, binder, lambda: lib)
            try:
                return fn(*call_args, **call_kwargs)
            finally:
                setattr(module, binder, cached)
        return run

    for label, case in cases.items():
        runs = {tree: runner(case, tree) for tree in ("parent", "change")}
        n = case[3]
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        times = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for tree in ("parent", "change", "change", "parent"):
                times[tree].append(window_ms(runs[tree], n))
        med = {t: float(np.median(v)) for t, v in times.items()}
        summary["ms"][label] = {"median": med, "windows": times}
        print(f"{label}: this tree {med['change']:.4f} ms, parent "
              f"{med['parent']:.4f} ms (ratio "
              f"{med['change'] / med['parent']:.4f}; windows of {n}: "
              f"{[round(t, 4) for t in times['change']]} / "
              f"{[round(t, 4) for t in times['parent']]}) on {name}",
              flush=True)
    if parent_bf16 is not None:
        for label, (c, lay, dens) in bf16_cases().items():
            runs = {"parent": lambda: parent_bf16_launch(parent_bf16, lay,
                                                         dens),
                    "change": lambda: fused.contraction_bf16_launch(c,
                                                                    dens)}
            outs = {tree: run() for tree, run in runs.items()}
            torch.cuda.synchronize()
            ulps = max(max_ulps(outs["parent"][k], outs["change"][k])
                       for k in range(2))
            del outs
            times = {"parent": [], "change": []}
            for _ in range(args.rounds):
                for tree in ("parent", "change", "change", "parent"):
                    times[tree].append(window_ms(runs[tree], 5))
            med = {t: float(np.median(v)) for t, v in times.items()}
            summary["ms"][label] = {"median": med, "windows": times,
                                    "max_ulps": ulps}
            print(f"{label}: this tree {med['change']:.4f} ms, parent "
                  f"{med['parent']:.4f} ms (ratio "
                  f"{med['change'] / med['parent']:.4f}; windows of 5: "
                  f"{[round(t, 4) for t in times['change']]} / "
                  f"{[round(t, 4) for t in times['parent']]}); results "
                  f"within {ulps:.3g} bf16 ulp of each other, on {name}",
                  flush=True)
            del dens
            torch.cuda.empty_cache()
        bf16 = [v["median"] for k, v in summary["ms"].items()
                if k.startswith("contraction_bf16")]
        print(f"contraction_bf16 over the six inputs: this tree "
              f"{sum(m['change'] for m in bf16):.4f} ms, parent "
              f"{sum(m['parent'] for m in bf16):.4f} ms on {name}")
    (OUT / "parent_turns.json").write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
