"""The port's entry points run on the CUDA device unless the caller asks
for the CPU: ``device`` defaults to ``"cuda"``, which raises where torch
finds no card (never a silent CPU run), and ``device=None`` raises."""

import inspect

import numpy as np
import pytest
import torch

import tabcorr_tpu_torch as ttt
from tabcorr_tpu_torch import mcmc, predictor

from conftest import DATA_DIR

ENTRY_POINTS = [ttt.make_predictor, ttt.make_multi_predictor,
                ttt.make_occupation_predictor, ttt.params_batch,
                predictor.stacked_grid, ttt.TabCorr.table_data,
                mcmc.make_gaussian_logpost_batched,
                mcmc.make_gaussian_logpost]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_points_default_to_cuda(fn):
    param = inspect.signature(fn).parameters["device"]
    assert param.kind == param.KEYWORD_ONLY and param.default == "cuda"


def test_make_predictor_without_a_device_runs_on_the_card_or_raises():
    tab = ttt.TabCorr.read(DATA_DIR / "examples" / "bolplanck_wp.hdf5")
    model = ttt.Zheng07Model(threshold=-18, redshift=tab.attrs["redshift"])
    calls = [lambda: ttt.make_predictor(tab, model),
             lambda: ttt.make_multi_predictor([tab], model),
             lambda: ttt.params_batch(model, batch_shape=(2,)),
             lambda: tab.table_data(),
             lambda: mcmc.make_gaussian_logpost_batched(
                 None, (), {}, [np.zeros(2)], [np.eye(2)])]
    if not torch.cuda.is_available():
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    else:
        params = ttt.params_batch(model, batch_shape=(2,))
        assert params["alpha"].is_cuda
        ngal, xi = ttt.make_predictor(tab, model)(params)
        assert ngal.is_cuda and xi.is_cuda
    # device=None is never a default: it raises.
    for call in (lambda: ttt.make_predictor(tab, model, device=None),
                 lambda: ttt.params_batch(model, device=None)):
        with pytest.raises(ValueError, match="device"):
            call()
