"""The tenants of the fleet tests as plain numbers (no JAX import, so
that a child process of the tests can rebuild them): four ARIMA(2,1,2)+c
tenants ``a0``-``a3`` and two additive Holt-Winters tenants ``h0``,
``h1`` of 4 series, their 120 observations of history and their live
ticks, and each tenant's model in the port."""

import numpy as np

from spark_timeseries_tpu_torch.models import convert as mconv

S, N_HIST, K = 4, 120, 24
PERIOD = 4
N_ARIMA, N_HW = 4, 2
LABELS = [f"a{i}" for i in range(N_ARIMA)] + [f"h{i}" for i in range(N_HW)]


def _panel(label):
    """History and live ticks of one tenant: ``(S, N_HIST + K)``."""
    seed = LABELS.index(label) + 11
    rng = np.random.default_rng(seed)
    n = N_HIST + K
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, n + 16):
        y[:, t] = 0.3 + 0.5 * y[:, t - 1] - 0.2 * y[:, t - 2] + e[:, t]
    y = y[:, 16:]
    if label.startswith("a"):
        return np.cumsum(y, axis=1)
    return 10.0 + 2.0 * np.sin(2 * np.pi * np.arange(n) / PERIOD) + 0.3 * y


def coefficients(label):
    rng = np.random.default_rng(LABELS.index(label) + 41)
    if label.startswith("a"):
        return np.column_stack([
            rng.uniform(-0.1, 0.1, S), rng.uniform(0.2, 0.5, S),
            rng.uniform(-0.3, 0.0, S), rng.uniform(-0.4, 0.4, S),
            rng.uniform(-0.2, 0.2, S)])
    a, b, g = (rng.uniform(0.1, 0.6, S) for _ in range(3))
    return a, b * 0.2, g


def history(label):
    return _panel(label)[:, :N_HIST]


def ticks(label):
    """``(S, K)`` live ticks."""
    return _panel(label)[:, N_HIST:]


def port_model(label):
    """The tenant's model in the port (float64, on the CPU)."""
    c = coefficients(label)
    if label.startswith("a"):
        return mconv.arima_from_numpy(2, 1, 2, c, device="cpu")
    return mconv.holt_winters_from_numpy("additive", PERIOD, *c,
                                         device="cpu")
