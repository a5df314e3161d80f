"""CPU tests of the benchmark's harness: the manifest and what it names,
the metric arithmetic, the roofline counts, the traffic and table
generators, the last line's schema, and the refusal without a card.

Run from the root of the checkout:
``python -m pytest -q -p no:cacheprovider benchmark/tests``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from benchlib import manifest, roofline, spans, trace, traffic  # noqa: E402
from benchlib import window  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


# ---- the manifest and the files it names --------------------------------
def test_manifest_has_the_contract_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = ([c["name"] for c in MANIFEST["configs"]] +
             [w["name"] for w in MANIFEST["workloads"]] +
             [m["name"] for m in MANIFEST["end_to_end"]] +
             [m["name"] for m in MANIFEST["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in MANIFEST[group]]
        assert len(group_names) == len(set(group_names))
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_config_is_used_and_its_files_are_there():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (BENCH / "systems" / f"{cfg['system']}.py").exists()
        assert (BENCH / "reference" / f"{cfg['reference']}.py").exists()
        assert set(cfg["sampled"]) <= set(cfg["fiducial"])
        assert set(cfg["limits"]) >= {"ngal_rel_err", "logpost_err",
                                      "walker_err", "accept_flips",
                                      "nan_rows_mismatch"}
        for t in cfg["tables"]:
            key = "_rel_err" if t["accuracy"] == "elementwise" else \
                "_scaled_err"
            assert t["statistic"] + key in cfg["limits"]
            if "file" in t:
                assert (ROOT / t["file"]).exists()
        for lo, hi in cfg["bounds"].values():
            # Edges a float32 number, so both sides test the same edge.
            assert float(np.float32(lo)) == lo and float(np.float32(hi)) == hi


def test_workloads_find_their_traffic_and_metrics():
    m = manifest.Manifest()
    e2e = {x["name"] for x in MANIFEST["end_to_end"]}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = m.cell(w["name"])
        assert cell.traffic["walkers"] % 2 == 0
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    for metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.0 < metric["bound"] <= 0.25
        assert UNIT.match(metric["unit"])
    for metric in MANIFEST["per_layer"]:
        assert metric["moves"] in e2e
        assert UNIT.match(metric["unit"])
        assert callable(manifest.load("metrics", metric["name"]).read)
        for w in metric.get("workloads", []):
            assert w in m.workload_names()
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_a_traffic_mix_is_data_only():
    for path in (BENCH / "traffic").iterdir():
        t = json.loads(path.read_text())
        assert {"walkers", "spread", "stretch_a", "warmup_steps"} <= set(t)


# ---- the metric arithmetic ----------------------------------------------
def test_rate_and_tail_take_the_whole_window():
    assert window.rate(4096, 500, 2.0) == 4096 * 250
    steps = [1.0] * 95 + [10.0] * 5
    assert window.p95(steps) == pytest.approx(np.percentile(steps, 95))
    # A stall anywhere shows in the tail.
    assert window.p95([1.0] * 90 + [50.0] * 10) == 50.0


def test_self_times_subtract_direct_children():
    records = [("sampler", 0, 100), ("logpost", 10, 40),
               ("predictor", 15, 35), ("logpost", 50, 90),
               ("predictor", 55, 60)]
    got = spans.summary(records)
    assert got["sampler"] == (1, 100, 100 - 30 - 40)
    assert got["logpost"] == (2, 70, (30 - 20) + (40 - 5))
    assert got["predictor"] == (2, 25, 25)
    assert spans.innermost(records, 20) == "predictor"
    assert spans.innermost(records, 45) == "sampler"
    assert spans.innermost(records, 200) is None


def test_spans_record_only_when_on():
    s = spans.Spans()
    f = s.wrap("x", lambda v: v + 1)
    assert f(1) == 2 and s.records == []
    s.on = True
    assert f(2) == 3 and len(s.records) == 1 and s.records[0][0] == "x"


def test_idle_share_from_the_union_of_intervals():
    kernels = [("a", 10, 20), ("b", 20, 10), ("c", 60, 10), ("d", 65, 30)]
    # Union in [0, 100]: [10, 30) and [60, 95).
    assert trace.busy_ns(kernels, 0, 100) == 20 + 35
    assert trace.idle_gaps(kernels, 0, 100) == [(0, 10), (30, 60), (95, 100)]
    # Clipped to the slice.
    assert trace.busy_ns(kernels, 15, 70) == 15 + 10


def test_kernels_are_found_by_their_own_name():
    names = ["void (anonymous namespace)::bundle_kernel<64, 0>((anonymous "
             "namespace)::BundleArgs)",
             "void (anonymous namespace)::grid_kernel<64, true, 0>((anonymous"
             " namespace)::GridArgs)",
             "void (anonymous namespace)::grid_tc_kernel<64, 0>(Args)",
             "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize32x32x32"]
    kernels = [(n, 0, k + 1) for k, n in enumerate(names)]
    assert trace.kernel_times_ns(kernels, "bundle_kernel") == [1]
    assert trace.kernel_times_ns(kernels, "grid_kernel") == [2]
    assert trace.short_name(names[1]) == \
        "(anonymous namespace)::grid_kernel<64, true, 0>"
    top = trace.top_ops(kernels + [(names[1], 5, 10)], n=2)
    assert top[0] == ["(anonymous namespace)::grid_kernel<64, true, 0>",
                      12 / 1e9]


# ---- the roofline counts, by hand ----------------------------------------
def test_b1_counts_for_one_row_by_hand():
    # wp: 60 bins, 19 rows, auto; xi_ell: 120 bins, 42 rows; 10 nodes.
    # quadrature 2 x 60 x 10 = 1200; pairs 60 x 61 / 2 = 1830; contraction
    # 1830 + 2 x 19 x 1830 = 71370; xi_ell: 2400, 7260 + 2 x 42 x 7260 =
    # 617100.
    assert roofline.quadrature_flop(60, 10) == 1200
    assert roofline.contraction_flop(60, 19, True) == 71370
    assert roofline.quadrature_flop(120, 10) == 2400
    assert roofline.contraction_flop(120, 42, True) == 617100
    assert roofline.contraction_flop(60, 19, False) == 2 * 19 * 60
    # Bytes of the wp table: 19 x 1830 stored floats, 3 x 600 node floats,
    # 2 x 60 bin floats, 4 bytes each.
    assert roofline.table_bytes(60, 10, 19, True) == 4 * (34770 + 1800 + 120)


def test_grid_counts_for_one_row_by_hand():
    # 1200 + 1830 + 2 x 64 x 42 x 1831 = 3030 + 9843456.
    assert roofline.grid_flop(60, 10, 64, 42) == 9846486
    assert roofline.table_bytes(60, 10, 42, True, 64) == 4 * (
        64 * 42 * 1830 + 1800 + 120)
    assert roofline.chi2_flop(61) == 2 * 61 * 61 + 3 * 61


def test_work_of_a_cell_and_the_peak():
    from benchlib.cell import work_of

    class Ref:
        def shapes(self):
            return [(60, 10, 19, True, 1), (120, 10, 42, True, 1)]

    call_work, step_flop = work_of(Ref(), {"fiducial": dict.fromkeys("abcde")})
    flop, n_bytes = call_work(2)
    assert flop == 2 * (1200 + 71370 + 2400 + 617100)
    assert n_bytes == (2 * 5 * 4 + roofline.table_bytes(60, 10, 19, True) +
                       roofline.table_bytes(120, 10, 42, True) +
                       2 * (20 + 43) * 4)
    assert step_flop(4) == 4 * (692070 + roofline.chi2_flop(19) +
                                roofline.chi2_flop(42))
    # A kernel that took exactly the bound reads 100%.
    assert roofline.share_pct(989e12, 0, 1.0) == pytest.approx(100.0)
    assert roofline.share_pct(0, 3.35e12, 2.0) == pytest.approx(50.0)


# ---- seeds, traffic and tables -------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3])
def test_every_seed_gives_its_own_streams(seed):
    a = traffic.stream_seed(seed, "walkers")
    assert 0 <= a < 2 ** 63
    assert a != traffic.stream_seed(seed, "sampler")
    assert a != traffic.stream_seed(seed + 1, "walkers")
    t = {"walkers": 16, "spread": 0.02}
    w1 = traffic.walkers_around([11.0, 0.5], t, seed, "cpu")
    w2 = traffic.walkers_around([11.0, 0.5], t, seed, "cpu")
    assert w1.dtype == torch.float32 and w1.shape == (16, 2)
    assert torch.equal(w1, w2)


def test_the_grid_tables_follow_the_seed():
    m = manifest.Manifest()
    cfg = m.config("zheng07_grid64")
    gen = manifest.load("tables", cfg["grid"]["generator"])
    a = gen.make(cfg["grid"], traffic.generator(5, "tables", "cpu"), "cpu")
    b = gen.make(cfg["grid"], traffic.generator(5, "tables", "cpu"), "cpu")
    c = gen.make(cfg["grid"], traffic.generator(6, "tables", "cpu"), "cpu")
    cols, matrices, keys, values = a
    assert matrices.shape == (64, 42, 1830)
    assert np.array_equal(matrices, b[1]) and not np.array_equal(matrices,
                                                                 c[1])
    assert keys == ["alpha_c", "alpha_s", "log_eta"]
    assert values.shape == (64, 3)
    for k, key in enumerate(keys):
        assert np.array_equal(np.unique(values[:, k]),
                              cfg["grid"]["axes"][key])
    assert list(cols["gal_type"]).count(b"centrals") == 30


# ---- the last line and the refusals ---------------------------------------
def test_the_last_line_has_the_contract_schema():
    args = run.parse(["--workload", "wp_xiell.walkers262k", "--seed",
                      str(2 ** 31 + 99), "--seconds", "0.3", "--trace", "0"])
    line, checks = run.run(args, "cpu", walkers=64)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    units = {m["name"]: m["unit"] for m in
             manifest.Manifest().cell("wp_xiell.walkers262k").end_to_end}
    assert set(line["metrics"]) == set(units) == {
        "walker_steps_per_s", "step_ms_p95", "setup_s"}
    for name, metric in line["metrics"].items():
        assert metric["unit"] == units[name] and metric["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert [c[0] for c in checks] == list(line["checks"])
    json.dumps(line)


def test_a_traced_line_carries_the_breakdown():
    args = run.parse(["--workload", "grid64.walkers262k", "--seed", "31",
                      "--seconds", "0.3", "--trace", "1"])
    line, _ = run.run(args, "cpu", walkers=64)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in MANIFEST["per_layer"]}
    assert set(line["metrics"]) <= per_layer


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "wp_xiell.walkers262k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_outside_a_checkout_of_the_port_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the port is missing: the run raises before any result (here
    driven past the look for a card, which would refuse first)."""
    subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "benchmark")],
                   check=True)
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'benchmark'); import run; "
         "run.run(run.parse(['--workload', 'wp_xiell.walkers262k', '--seed', "
         "'1', '--seconds', '1']), 'cpu', walkers=64)"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "tabcorr_tpu_torch" in proc.stderr
    assert "{" not in proc.stdout


# ---- what the benchmark imports -------------------------------------------
IMPORT_CHECK = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from benchlib import manifest
m = manifest.Manifest()
for w in m.workload_names():
    cell = m.cell(w)
    manifest.load("systems", cell.config["system"])
    manifest.load("reference", cell.config["reference"])
    for metric in cell.per_layer:
        manifest.load("metrics", metric["name"])
import tabcorr_tpu_torch.mcmc, tabcorr_tpu_torch.predictor
print(" ".join(run.forbidden_modules()) or "none")
"""

REFERENCE_CHECK = r"""
import sys
sys.path[:0] = [{bench!r}]
from benchlib import manifest
for name in ("hod_tables", "ensemble"):
    manifest.load("reference", name)
print(sorted({{m.split(".")[0] for m in sys.modules}} &
             {{"tabcorr_tpu_torch", "tabcorr_tpu", "jax"}}))
"""


def test_nothing_the_run_imports_is_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK.format(bench=str(BENCH),
                                                   root=str(ROOT))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "none"


def test_the_reference_imports_nothing_of_the_program():
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_CHECK.format(bench=str(BENCH))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[-2] == "[]"
    for path in (BENCH / "reference").glob("*.py"):
        assert "tabcorr_tpu" not in re.sub(r'""".*?"""', "",
                                           path.read_text(), flags=re.S)


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("tabcorr_tpu_torch", sys.modules[__name__])
    assert "tabcorr_tpu" not in run.forbidden_modules()


# ---- the per-layer readers over a made-up traced run ------------------------
def test_every_reader_reads_its_number_from_a_traced_run():
    from benchlib.cell import Run
    # One traced step, then the profiler's stop (9 ms), then three steps.
    win = window.Window(seconds=2.0, steps=5,
                        step_ms=[5.0, 9.0, 1.0, 2.0, 3.0],
                        accepts=np.full(5, 0.3), traced_steps=(0, 1))
    records = [("sampler", 0, 1000), ("logpost", 100, 600),
               ("predictor", 200, 400), ("sampler", 2000, 2600),
               ("logpost", 2100, 2400), ("predictor", 2150, 2250)]
    kernels = [("void (anonymous namespace)::grid_kernel<64, true, 0>(A)",
                100, 500), ("Memcpy HtoD (Pageable -> Device)", 700, 100)]
    run_ = Run(window=win, spans=records, kernels=kernels,
               trace_window_ns=(0, 1000), call_rows=4,
               call_work=lambda rows: (rows * 989e3, 0), step_flop=8 * 989e6)
    got = {m["name"]: manifest.load("metrics", m["name"]).read(run_)
           for m in MANIFEST["per_layer"]}
    assert got["sampler.self_us_per_step"] == pytest.approx(
        ((1000 - 500) + (600 - 300)) / 2 / 1e3)
    assert got["logpost.self_us_per_call"] == pytest.approx(
        ((500 - 200) + (300 - 100)) / 2 / 1e3)
    assert got["predictor.host_us_per_call"] == pytest.approx(0.15)
    assert got["device.idle_pct"] == pytest.approx(40.0)
    # 4 rows x 989e3 FLOP at 989 TFLOP/s = 4 ns, over 500 ns a launch.
    assert got["grid_kernel_roofline"] == pytest.approx(0.8)
    assert got["bundle_kernel_roofline"] is None
    # 8 x 989e6 FLOP over the mean untraced interval, 2 ms, at 989 TFLOP/s.
    assert got["step_mfu"] == pytest.approx(100 * 8e6 / 2e-3 / 1e12)
