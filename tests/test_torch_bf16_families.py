"""The port's plain engine in bfloat16 against tabcorr_tpu's XLA engine in
bfloat16 for the other HOD families: Zu & Mandelbaum 15, Tinker13 and
Cacciato09, on the wp and Delta Sigma tables, with float32 and with
bfloat16 parameters.  The bar and the comparison are
test_torch_bf16_models.py's.
"""

import pytest
import torch

from test_torch_bf16_models import TABLES, objects, run_case  # noqa: F401

MODELS = {
    "zu15": lambda m: m.ZuMandelbaum15Model(threshold=10.3),
    "tinker13": lambda m: m.Tinker13Model(threshold=10.5, redshift=0.2),
    "cacciato09": lambda m: m.Cacciato09Model(threshold=9.8),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("name", list(MODELS))
def test_plain_bf16_engine_meets_jax_bar(objects, name, table, dtype):
    run_case(objects, MODELS, name, table, dtype,
             seed=10 + list(MODELS).index(name))
