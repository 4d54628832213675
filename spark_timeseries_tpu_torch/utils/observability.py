"""Profiling, timing and fit-convergence observability (counterpart of
``spark_timeseries_tpu/utils/observability.py``).

The reference's only in-library telemetry is ``println`` warnings for
non-stationary fits and ``seriesStats`` summaries; everything else is
delegated to the Spark UI.  Here: ``torch.profiler`` scopes and traces
(:func:`trace`, :func:`profile`), the shared wall-timing harnesses
(:func:`timed`, :func:`timed_min`), and structured convergence counters
off the batched optimizers (:func:`fit_report`).  Counters, spans and
the trace ring live next door in
:mod:`spark_timeseries_tpu_torch.utils.metrics`; :func:`fit_report`
feeds its registry so repeated fits accumulate.

Card work is asynchronous: a PyTorch call returns once its kernels are
enqueued.  :func:`timed` synchronises every device its result's tensors
live on before it reads the clock, and :func:`timed_min` copies every
output tensor to the host, where the JAX versions block on their results.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger("spark_timeseries_tpu_torch")

_configured_handler: Optional[logging.Handler] = None


def configure_logging(level=logging.INFO, stream=None) -> logging.Handler:
    """Opt-in console logging for the package logger.

    The package attaches no handler (library-logging hygiene: importing
    it never touches the root logger or prints anything), so
    ``fit_report``'s ``logger.info`` lines are invisible by default.  This
    helper makes them visible without the application configuring the
    root logger::

        observability.configure_logging("INFO")

    ``level`` is a logging level name or constant; ``stream`` defaults to
    stderr.  Idempotent — calling again replaces the previous handler
    (e.g. to change level or stream) instead of stacking duplicates.
    """
    global _configured_handler
    if isinstance(level, str):
        level = logging.getLevelName(level.upper())
    if _configured_handler is not None:
        logger.removeHandler(_configured_handler)
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
    # while this handler is active the package logger must not also
    # propagate to root, or an app with root logging configured would see
    # every record twice
    logger.propagate = False
    _configured_handler = handler
    return handler


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """Named profiler scope (``torch.profiler.record_function``); shows
    up in ``torch.profiler`` traces around the fit kernels.  For a scope
    that also records wall time into the metrics registry, use
    :func:`metrics.span`."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host, and the card when CUDA is available) and
    write its Chrome trace into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (view in Perfetto or ``chrome://tracing``).
    Yields the ``torch.profiler.profile`` object, whose events the
    caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in a result: tuples (NamedTuples too), lists, dicts
    and the attributes of result objects."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for v in vars(obj).values():
            yield from _tensors(v)


def _synchronize(result) -> Any:
    """Wait for every card the result's tensors live on; returns it."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return result


def _to_host(obj):
    """The result with every tensor copied to a host numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3,
          **kwargs) -> Dict[str, Any]:
    """Wall-time a callable, synchronising the devices of its result's
    tensors after each call; returns {mean_s, min_s, result}.  For the
    stricter materializing protocol (min estimator, host copy per rep),
    use :func:`timed_min`."""
    result = None
    for _ in range(warmup):
        result = _synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "min_s": float(np.min(times)),
            "result": result}


def timed_min(fn, *args, reps: int = 3, want_out: bool = False):
    """Wall-time ``fn(*args)`` (copying every output tensor to the host),
    min over ``reps`` after one warm call: per-call jitter is strictly
    additive noise, so the minimum is the cleanest estimator.  The host
    copy is part of the protocol: it is what waits for the card.
    ``want_out=True`` returns ``(seconds, out)`` with the last run's
    host outputs."""
    def materialize():
        return _to_host(fn(*args))

    out = materialize()                                  # warm + sync
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = materialize()
        best = min(best, time.perf_counter() - t0)
    return (best, out) if want_out else best


def fit_report(result_or_model, family: Optional[str] = None
               ) -> Dict[str, Any]:
    """Convergence counters — the batched answer to the reference's
    per-series println warnings.

    Accepts a batched ``MinimizeResult``, a ``FitDiagnostics``, or any fitted
    model (every ``fit`` attaches ``model.diagnostics``), so counting
    non-converged lanes is one call on the public fit output::

        model = arima.fit(2, 1, 2, panel)
        report = fit_report(model)          # {"n_converged": ..., ...}

    Besides the headline counts the report carries ``frac_converged`` and
    the iteration distribution (``iters_mean``/``iters_p50``/``iters_p95``/
    ``iters_max``) — every lane of a batched fit waits for the slowest
    lane's iterations, so the p95/max gap is the first thing to read when
    a fit stage regresses.  Each report is also accumulated into the
    metrics registry as a ``fit_report.<family>.*`` counter bundle
    (:func:`metrics.record_fit_report`); ``family`` defaults to a name
    derived from the input's type (``ARIMAModel`` -> ``arima``).
    """
    from .metrics import _host, record_fit_report

    source = result_or_model
    diag = getattr(result_or_model, "diagnostics", None)
    if diag is not None:
        result_or_model = diag
    if not hasattr(result_or_model, "converged"):
        raise TypeError(
            f"{type(result_or_model).__name__} carries no fit diagnostics "
            "(was it produced by a fit()?)")
    if family is None:
        import re
        name = type(source).__name__
        for suffix in ("Model", "Result", "Diagnostics"):
            if name.endswith(suffix):
                name = name[:-len(suffix)]
                break
        # snake_case so the derived family matches the instrument_fit
        # bundle spelling (HoltWintersModel -> holt_winters)
        name = re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])",
                      "_", name)
        family = name.lower() or "fit"
    converged = _host(result_or_model.converged)
    n_iter = _host(result_or_model.n_iter)
    fun = _host(result_or_model.fun)
    n_series = int(converged.size)
    n_converged = int(np.sum(converged))
    report = {
        "n_series": n_series,
        "n_converged": n_converged,
        "frac_converged": (n_converged / n_series) if n_series else 0.0,
        "n_diverged": int(np.sum(~np.isfinite(fun))),
        "iters_mean": float(np.mean(n_iter)) if n_iter.size else 0.0,
        "iters_p50": float(np.percentile(n_iter, 50)) if n_iter.size else 0.0,
        "iters_p95": float(np.percentile(n_iter, 95)) if n_iter.size else 0.0,
        "iters_max": int(np.max(n_iter)) if n_iter.size else 0,
    }
    record_fit_report(family, report)
    logger.info("fit_report %s %s", family, json.dumps(report))
    return report
