"""``ServingSession.heal`` of an ARIMA(2,1,2)+c session, the port against
the JAX package on the CPU in float64 (the JAX refit takes the longest
of the families to trace, so it has a file of its own;
``torch_serving_cases.check_heal_matches_jax`` says what is held), and
the port's default heal with the auto-order stage."""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch.statespace import serving
from spark_timeseries_tpu_torch.utils import resilience
from torch_serving_cases import (N_HIST, S, bitwise, check_heal_matches_jax,
                                 start)

pytestmark = pytest.mark.serving

torch.set_num_threads(1)


def test_heal_after_state_poison_matches_jax():
    check_heal_matches_jax("arima")


def test_arima_heal_with_auto_order_recovers_every_lane():
    """The default heal (``auto_order=True``) on the ARIMA session: the
    refit chain's statistics come back through ``stats``, every poisoned
    lane heals and the others keep their state bit for bit."""
    _, ts, y, _ = start("arima")
    with resilience.fault_injection("state_poison", lane_stride=4):
        ts.update(y[:, N_HIST])
    ts.update(y[:, N_HIST + 1])
    before = ts._state.a.clone()
    st = {}
    rep = ts.heal(stats=st)
    assert rep["healed"] == rep["quarantined"] == 4
    assert st["lm_fit_launches"] == 0       # the CPU runs the plain LM
    assert ts.health_counts() == {"ok": S}
    keep = np.arange(S) % 4 != 0
    bitwise([ts._state.a[keep].numpy()], [before[keep].numpy()])
    assert serving.ServingSession.heal(ts) == {"quarantined": 0,
                                               "healed": 0, "dead": 0}
