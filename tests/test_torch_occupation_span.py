"""The occupation launch's span: ``fused.occupation_launch`` records the
batch (``rows``) and the node plan's distinct abscissae a row
(``abscissae``) while a profiler records, and nothing without one.

The CPU tests stand a stub in for the kernel's launch (there is no card);
the test marked ``gpu`` launches the kernel on the ds_efficient grid and
skips without a card.  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_occupation_span.py
"""

import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tabcorr_tpu_torch as tt
from tabcorr_tpu_torch.ops import fused
from tabcorr_tpu_torch.predictor import stacked_grid
from tabcorr_tpu_torch.utils import profiling

DATA = Path(tt.__file__).parent / "data"


def _spans(start_ns, name="fused.occupation_launch"):
    return [s for s in profiling.recorded()
            if s.start_ns >= start_ns and s.name == name]


def _plan(device):
    """The ds_efficient grid's node plan and the decorated Leauthaud11
    family, as the fused Interpolator route builds them."""
    interp = tt.Interpolator.read(DATA / "ds_efficient.npz")
    table, n_nodes, _ = stacked_grid(interp, device=device)
    consts = fused.grid_constants(table, n_nodes, "packed", "elementwise",
                                  torch.device(device).type)
    model = tt.AssembiasLeauthaud11Model(
        threshold=10.5, redshift=0.5, prim_haloprop_key="halo_m258m")
    return consts, model


def _columns(model, fam, rows, device):
    return fused.family_columns(
        {k: torch.full((rows,), float(model.param_dict[k]),
                       dtype=torch.float32, device=device)
         for k in fam.param_names}, fam)


def test_the_span_counts_rows_and_abscissae_and_only_under_a_profiler(
        monkeypatch):
    consts, model = _plan("cpu")
    plan = fused.occupation_plan([consts])
    fam = fused.OccupationFamily.of(model)
    cols = _columns(model, fam, 6, "cpu")
    launched = []
    monkeypatch.setattr(fused, "_occupation_launch",
                        lambda *args: launched.append(args) or ["dens"])
    start = time.time_ns()
    count = fused.OCCUPATION_LAUNCHES
    assert fused.occupation_launch(plan, fam, cols) == ["dens"]
    assert _spans(start) == []
    with profile(activities=[ProfilerActivity.CPU]):
        fused.occupation_launch(plan, fam, cols, bin_major=False)
    [span] = _spans(start)
    assert span.counts == {"rows": 6, "abscissae": plan.n_distinct}
    # ds_efficient: 280 mass bins' 10 nodes, centrals and satellites alike.
    assert plan.n_distinct == 2800
    assert len(launched) == 2 and launched[1][3] is False
    assert fused.OCCUPATION_LAUNCHES == count + 2


def test_a_refused_launch_records_its_span_and_counts_no_launch():
    consts, model = _plan("cpu")
    plan = fused.occupation_plan([consts])
    fam = fused.OccupationFamily.of(model)
    count = fused.OCCUPATION_LAUNCHES
    start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused.occupation_launch(plan, fam, _columns(model, fam, 4, "cpu"))
    [span] = _spans(start)
    assert span.counts == {}
    assert fused.OCCUPATION_LAUNCHES == count


@pytest.mark.gpu
def test_on_the_card_the_launch_records_its_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    consts, model = _plan("cuda")
    plan = consts.occupation_plan
    fam = fused.OccupationFamily.of(model)
    cols = _columns(model, fam, 4096, "cuda")
    fused.occupation_launch(plan, fam, cols)
    torch.cuda.synchronize()
    start = time.time_ns()
    fused.occupation_launch(plan, fam, cols)
    torch.cuda.synchronize()
    assert _spans(start) == []
    with profile(activities=[ProfilerActivity.CUDA]):
        dens, = fused.occupation_launch(plan, fam, cols)
        torch.cuda.synchronize()
    [span] = _spans(start)
    assert span.counts == {"rows": 4096, "abscissae": 2800}
    assert dens.shape == (1104, 4096) and bool(torch.isfinite(dens).all())
