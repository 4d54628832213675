"""Plotting: line plots, forecasts and ACF/PACF with confidence bands
(counterpart of ``spark_timeseries_tpu/utils/plot.py``).

Capability parity with the reference's ``EasyPlot``, with matplotlib
replacing breeze-viz.  PACF uses the AR(maxLag) coefficients exactly as
the reference does.  matplotlib and scipy are imported inside the
functions: importing the package needs neither.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import autoregression
from ..ops.univariate import autocorr


def _figure():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt.subplots()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def calc_conf_val(conf: float, n: int) -> float:
    """Two-sided normal confidence bound scaled by sqrt(n)
    (ref ``EasyPlot.scala:98-102``)."""
    from scipy.stats import norm
    return float(norm.ppf(1.0 - (1.0 - conf) / 2.0) / np.sqrt(n))


def ezplot(series, style: str = "-"):
    """Line plot of one series or a sequence of series
    (ref ``EasyPlot.scala:25-53``)."""
    fig, ax = _figure()
    arr = _host(series)
    if arr.ndim == 1:
        arr = arr[None, :]
    for row in arr:
        ax.plot(np.arange(row.size), row, style)
    return fig


def forecast_plot(data, model, n_future: int, conf: float = 0.95):
    """History, point forecast, and shaded prediction bands for one series
    — beyond reference (``EasyPlot`` has no forecast view).

    ``model`` is any fitted model exposing
    ``forecast_interval(ts, n_future, conf)`` (ARIMA, Holt-Winters
    additive, EWMA).  ARIMA's full-length output (historical one-step fits
    + future) is split automatically; the bands always cover exactly the
    ``n_future`` future steps.
    """
    arr = _host(data)
    if arr.ndim != 1:
        raise ValueError("forecast_plot draws one series; slice the panel")
    point, lo, hi = model.forecast_interval(torch.as_tensor(arr), n_future,
                                            conf)
    point, lo, hi = (_host(v) for v in (point, lo, hi))
    if point.ndim != 1:
        raise ValueError(
            "forecast_plot draws one series, but the model is panel-fitted "
            "(batched parameters); select one lane's model first")
    future = point[..., -n_future:] \
        if point.shape[-1] != n_future else point

    fig, ax = _figure()
    n = arr.shape[-1]
    t_fut = n - 1 + np.arange(n_future + 1)
    ax.plot(np.arange(n), arr, color="C0", label="observed")
    # prepend the last observation so the forecast connects visually
    ax.plot(t_fut, np.r_[arr[-1], future], color="C1", label="forecast")
    ax.fill_between(t_fut[1:], lo, hi, color="C1", alpha=0.25,
                    label=f"{int(round(conf * 100))}% band")
    ax.legend()
    return fig


def _draw_corr(ax, corrs: np.ndarray, conf_val: float) -> None:
    """Vertical correlation bars + horizontal confidence lines
    (ref ``EasyPlot.scala:104-119``)."""
    for i, c in enumerate(corrs):
        ax.plot([i + 1, i + 1], [0.0, c], color="C0")
    n = len(corrs)
    xs = np.arange(n + 1)
    for v in (conf_val, -conf_val):
        ax.plot(xs, np.full(n + 1, v), "-", color="red")


def acf_plot(data, max_lag: int, conf: float = 0.95):
    """Autocorrelation plot (ref ``EasyPlot.scala:61-75``)."""
    arr = _host(data)
    corrs = _host(autocorr(torch.as_tensor(arr), max_lag))
    fig, ax = _figure()
    ax.set_title("Autocorrelation function")
    ax.set_xlabel("Lag")
    ax.set_ylabel("Autocorrelation")
    _draw_corr(ax, corrs, calc_conf_val(conf, arr.size))
    return fig


def pacf_plot(data, max_lag: int, conf: float = 0.95):
    """Partial autocorrelation plot: the AR(maxLag) coefficients
    (ref ``EasyPlot.scala:77-96``)."""
    arr = _host(data)
    model = autoregression.fit(torch.as_tensor(arr), max_lag)
    pcorrs = _host(model.coefficients)
    fig, ax = _figure()
    ax.set_title("Partial autocorrelation function")
    ax.set_xlabel("Lag")
    ax.set_ylabel("Partial Autocorrelation")
    _draw_corr(ax, pcorrs, calc_conf_val(conf, arr.size))
    return fig
