"""PyTorch/CUDA port of ``spark_timeseries_tpu``.

The JAX package beside this one is the reference; this package computes
the same functions on tensors, with the JAX package's Pallas kernels as
hand-written CUDA kernels (``csrc/arma_ne.cu`` with ``arma_ne.cuh`` and
its ``arma_ne.orders*.cu``: the ARMA normal equations, the whole CSS
Levenberg-Marquardt fit, per series or over a candidate grid, and the
CSS cost; ``csrc/hw_sse.cu``: the Holt-Winters SSE value and gradient,
and the whole Holt-Winters box fit).  It imports neither ``jax`` nor
``spark_timeseries_tpu``.

Ported so far: the time core (``time``, a copy of the JAX package's),
the keyed :class:`Panel` with its univariate ops, fills and resampling,
the CSV / Parquet / Yahoo tier (``io``, with the C++ CSV codec
``csrc/fastcsv.cpp``), the batched ARIMA(p, d, q) CSS fit
(``models.arima.fit``, ``method="css-lm"``), the batched automatic ARIMA
order selection (``models.arima.auto_fit_panel``, with
``stats.kpsstest``), the batched Holt-Winters fit
(``models.holt_winters.fit``) and the streaming fit engine
(``engine.FitEngine.fit`` / ``stream_fit``, families ``arima``, ``ar``
and ``holt_winters``) with the ops they need; the volatility and
smoothing families; the exogenous-regressor families
(``models.autoregression_x``, ``models.arimax``,
``models.regression_arima``); the state-space core (``statespace``:
the Kalman filter and the exact likelihood that
``models.arima.fit(objective="exact")`` maximizes); the online serving
tier on it (``statespace.serving.ServingSession`` with lane health,
forecast quality, heal and checkpoint/restore) and the fleet over it
(``statespace.FleetScheduler``: admission, coalesced ticks, SLO
shedding, drain/adopt; ``statespace.FleetRuntime``: the supervised
pump, backpressure, checkpoint generations, rebalance); the long-series tier
(``longseries.fit_long``: one series of 10⁶–10⁸ observations split,
fitted as a batch of segments, combined and forecast exactly; and
``models.arima.fit_long``); and rolling-origin backtesting with
per-series champions (``backtest.backtest_panel``, ``Panel.backtest``).

Device policy: the entry points take ``device=None``, which means CUDA.
Without a card they raise unless the caller passes ``device="cpu"``.
On CUDA, panels and fits are float32; on the CPU, float32 and float64
are both allowed.
"""

from . import io, time
from ._device import default_device, resolve_device
from .panel import Panel, panel_from_numpy

__all__ = ["Panel", "default_device", "io", "panel_from_numpy",
           "resolve_device", "time"]
