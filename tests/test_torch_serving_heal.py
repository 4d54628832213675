"""``ServingSession.heal`` of the port against the JAX package's, on the
CPU in float64, for AR, ARX (no ring-history refit in either package),
EWMA and additive Holt-Winters; ARIMA is in
``test_torch_serving_heal_arima.py``
(``torch_serving_cases.check_heal_matches_jax`` says what is held)."""

import pytest
import torch

from torch_serving_cases import check_heal_matches_jax

pytestmark = pytest.mark.serving

torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["ar", "arx", "ewma", "holt_winters"])
def test_heal_after_state_poison_matches_jax(family):
    check_heal_matches_jax(family)
