"""The port's plain engine in bfloat16 against tabcorr_tpu's XLA engine in
bfloat16: zheng07, its assembly-bias decoration and Leauthaud11 on the
wp (auto) and Delta Sigma (cross) tables, fed the same float32
parameters and again the same bfloat16 parameters
(test_torch_bf16_families.py: the other families).

Bar: bfloat16 rounds at other places in the two frameworks, so each
route is compared with float64 (the port's plain float64 engine, which
the float64 tests hold to tabcorr_tpu at 1e-10) at the parameters as it
received them, and the port's error must be within max(2 x tabcorr_tpu's
error at the same probes, 2^-8): ngal relative, each statistic scaled
(max |err| / max |statistic| per row).  Both engines give float32
results, as tabcorr_tpu's does (its transcendentals return float32 for a
bfloat16 argument; under x64, which the tests enable, its Tinker13
spline returns float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tabcorr_tpu as tt
import tabcorr_tpu_torch as ttt
from tabcorr_tpu.predictor import make_predictor as jax_make_predictor

from conftest import DATA_DIR
from test_torch_families import ASSEMBIAS, port_model_of

FLOOR = 2.0 ** -8
BATCH = 16
TABLES = {"wp": DATA_DIR / "examples" / "bolplanck_wp.hdf5",
          "ds": DATA_DIR / "examples" / "bolplanck_ds.hdf5"}
MODELS = {
    "zheng07": lambda m: m.Zheng07Model(threshold=-20),
    "assembias zheng07": lambda m: m.AssembiasZheng07Model(threshold=-20),
    "leauthaud11": lambda m: m.Leauthaud11Model(threshold=10.5,
                                                redshift=0.3),
}


def f64(x):
    """A tensor (bfloat16 too) or an array as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def scaled_error(got, ref):
    """Largest per-row max |got - ref| / max |ref| (tensors or arrays of
    (B, ...)), over the rows where both are finite."""
    got = f64(got).reshape(len(ref), -1)
    ref = f64(ref).reshape(len(ref), -1)
    ok = np.isfinite(got).all(1) & np.isfinite(ref).all(1)
    return float(np.max(np.max(np.abs(got[ok] - ref[ok]), axis=1) /
                        np.max(np.abs(ref[ok]), axis=1)))


def errors(out, ref):
    """(ngal error, xi error) of a predictor's output against float64."""
    return (scaled_error(f64(out[0])[:, None], f64(ref[0])[:, None]),
            scaled_error(out[1], ref[1]))


def draw(model, batch, seed):
    """Every parameter within ~1% of its value (float64); assembly-bias
    strengths uniform in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(-1.0, 1.0, batch) if k in ASSEMBIAS else
                v + 0.01 * abs(v) * rng.normal(size=batch))
            for k, v in model.param_dict.items()}


def as_received(params, dtype):
    """(port tensors of ``dtype``, the same values in float64 tensors, the
    same values as tabcorr_tpu arrays of the matching dtype)."""
    port = {k: torch.tensor(v).to(dtype) for k, v in params.items()}
    wide = {k: v.double() for k, v in port.items()}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax = {k: jnp.asarray(v.numpy(), dtype=jdt) for k, v in wide.items()}
    return port, wide, jax


def check_against_jax(got, want, ref, what):
    """Assert the port's (ngal, xi) meet the bar against tabcorr_tpu's,
    both against float64 ``ref``."""
    for name, have, bar in zip(("ngal", "xi"), errors(got, ref),
                               errors(want, ref)):
        assert have <= max(2.0 * bar, FLOOR), (what, name, have, bar)


@pytest.fixture(scope="module")
def objects():
    return {k: (tt.TabCorr.read(f), ttt.TabCorr.read(f))
            for k, f in TABLES.items()}


def run_case(objects, models, name, table, dtype, seed):
    jax_obj, obj = objects[table]
    jax_model = models[name](tt)
    model = port_model_of(jax_model)
    port_p, p64, jax_p = as_received(draw(jax_model, BATCH, seed), dtype)
    got = ttt.make_predictor(obj, model, dtype=torch.bfloat16,
                             engine="plain", device="cpu")(port_p)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[1].shape == (BATCH,) + tuple(obj.tpcf_shape)
    want = jax_make_predictor(jax_obj, jax_model, dtype=jnp.bfloat16,
                              engine="xla")(jax_p)
    ref = ttt.make_predictor(obj, model, dtype=torch.float64,
                             engine="plain", device="cpu")(p64)
    check_against_jax(got, want, ref, (name, table, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("name", list(MODELS))
def test_plain_bf16_engine_meets_jax_bar(objects, name, table, dtype):
    run_case(objects, MODELS, name, table, dtype,
             seed=list(MODELS).index(name))


def test_satellite_residual_blows_up_at_a_bf16_node_in_both_packages(
        objects):
    """zheng07's satellites absorb a node's residual to first order,
    res / (1 - M0 / M) (``models/zheng07.py``).  With bfloat16 nodes the
    residual is up to ~0.03 dex, and where logM0 lies just below a node
    (11.6875 on the wp table) the term explodes in both packages' bf16
    engines alike; the float64 ngal there is 5.55e-3.  A shared defect of
    the reference's bf16 route, pinned here (ROADMAP, Queue C)."""
    jax_tab, tab = objects["wp"]
    jax_model = tt.Zheng07Model(threshold=-20)
    model = port_model_of(jax_model)
    p = {k: np.full(2, v) for k, v in jax_model.param_dict.items()}
    p["logM0"] = np.array([11.687, 11.6873])
    port_p, p64, jax_p = as_received(p, torch.float32)
    ref = ttt.make_predictor(tab, model, dtype=torch.float64,
                             device="cpu")(p64)[0]
    got = ttt.make_predictor(tab, model, dtype=torch.bfloat16,
                             engine="plain", device="cpu")(port_p)[0]
    want = jax_make_predictor(jax_tab, jax_model, dtype=jnp.bfloat16,
                              engine="xla")(jax_p)[0]
    assert np.all(np.abs(f64(ref) - 5.55e-3) < 1e-5)
    for out in (got, want):
        assert np.all(~np.isfinite(f64(out)) | (f64(out) > 1e3 * f64(ref)))
