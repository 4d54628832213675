"""Shared cases of the fleet parity tests (``test_torch_fleet.py``,
``test_torch_fleet_runtime.py``): tenants built in the JAX package and
carried across with ``models.convert`` (four ARIMA(2,1,2)+c tenants and
two additive Holt-Winters tenants of 4 series, 120 observations of
history), both packages' sessions on them, and helpers that drive the
same scenario through either package's fleet."""

import types

import jax.numpy as jnp
import numpy as np
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.statespace import fleet as j_fleet
from spark_timeseries_tpu.statespace import runtime as j_runtime
from spark_timeseries_tpu.statespace import serving as j_serving
from spark_timeseries_tpu.utils import lineage as j_lineage
from spark_timeseries_tpu.utils import metrics as j_metrics
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch.statespace import fleet as t_fleet
from spark_timeseries_tpu_torch.statespace import runtime as t_runtime
from spark_timeseries_tpu_torch.statespace import serving as t_serving
from spark_timeseries_tpu_torch.utils import lineage as t_lineage
from spark_timeseries_tpu_torch.utils import metrics as t_metrics
from spark_timeseries_tpu_torch.utils import resilience as t_res
from torch_fleet_data import (K, LABELS, N_ARIMA, N_HIST, N_HW,  # noqa: F401
                              PERIOD, S, coefficients, history, port_model,
                              ticks)

RTOL = 1e-10

JAX = types.SimpleNamespace(
    name="jax", fleet=j_fleet, runtime=j_runtime, serving=j_serving,
    lineage=j_lineage, metrics=j_metrics, res=j_res, kw={})
PORT = types.SimpleNamespace(
    name="port", fleet=t_fleet, runtime=t_runtime, serving=t_serving,
    lineage=t_lineage, metrics=t_metrics, res=t_res, kw={"device": "cpu"})


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def bitwise(a, b):
    for x, y in zip(a, b):
        x = np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                                 else x)
        y = np.ascontiguousarray(y.numpy() if isinstance(y, torch.Tensor)
                                 else y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def model(api, label):
    """The tenant's model in ``api``'s package (the port's carried across
    from the JAX package's numbers with ``models.convert``)."""
    if api is PORT:
        return port_model(label)
    c = coefficients(label)
    if label.startswith("a"):
        return j_arima.ARIMAModel(2, 1, 2, jnp.asarray(c), True)
    return j_hw.HoltWintersModel("additive", PERIOD,
                                 *(jnp.asarray(x) for x in c))


def session(api, label, registry, **kw):
    return api.serving.ServingSession.start(
        model(api, label), history(label), label=label, registry=registry,
        **api.kw, **kw)


def scheduler(api, labels, policy=None, registry=None, **kw):
    """A scheduler of ``api``'s package over the named tenants (manual
    pump) and its registry."""
    reg = registry if registry is not None else api.metrics.MetricsRegistry()
    sched = api.fleet.FleetScheduler(policy, registry=reg, auto_pump=False,
                                     **api.kw, **kw)
    for la in labels:
        sched.attach(session(api, la, reg))
    return sched, reg


def fleet_counters(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(("fleet.", "serving.")) and "e2e" not in k}


def record_ticks(sess, log):
    """Append every TickResult the session absorbs to ``log``."""
    orig = sess._absorb_tick

    def absorb(host, state2, health2, out, dt_s, qstate2=None,
               lineage=None):
        log.append(out)
        return orig(host, state2, health2, out, dt_s, qstate2,
                    lineage=lineage)

    sess._absorb_tick = absorb


def session_view(sess):
    """The numbers of a session the parity tests compare."""
    st = sess._state
    host = (lambda x: x.numpy()) if isinstance(st.a, torch.Tensor) \
        else np.asarray
    n = sess.n_series
    return {"a": host(st.a)[:n], "P": host(st.P)[:n],
            "loglik": np.asarray(sess.loglik),
            "ew": host(sess._health.ew)[:n],
            "status": np.asarray(sess.lane_status),
            "ticks_seen": sess.ticks_seen,
            "ring": np.asarray(sess._ring_history())}


def assert_views_close(got, want):
    assert got["ticks_seen"] == want["ticks_seen"]
    np.testing.assert_array_equal(got["status"], want["status"])
    for k in ("a", "P", "loglik", "ew", "ring"):
        close(got[k], want[k])


def lineage_counts(api):
    doc = api.lineage.lineage_summary()
    return {"started": doc["started"], "outcomes": doc["outcomes"],
            "open": doc["open"],
            "duplicates": doc["duplicate_completions"]}


def fixed_latency(sched, box):
    """Feed the SLO window ``box[0]`` seconds per dispatch instead of the
    measured wall time: the shed ladder runs the same in both packages
    and on any machine."""
    orig = sched._note_latency
    sched._note_latency = lambda dt_s: orig(box[0])
