"""Shared cases of the serving parity tests (``test_torch_serving.py``,
``test_torch_serving_heal.py``): for each serving family one model built
in the JAX package and carried across with ``models.convert``, its
16-series history and ticks, and both packages' sessions on them."""

import jax.numpy as jnp
import numpy as np

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import autoregression as j_ar
from spark_timeseries_tpu.models import autoregression_x as j_arx
from spark_timeseries_tpu.models import ewma as j_ewma
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.statespace import serving as j_ss
from spark_timeseries_tpu.utils import metrics as j_metrics
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.statespace import health, serving
from spark_timeseries_tpu_torch.utils import metrics, resilience

RTOL = 1e-10
HEAL_RTOL = 1e-8
S, N_HIST, K = 16, 64, 6
PERIOD = 4
FAMILIES = ["arima", "ar", "arx", "ewma", "holt_winters"]


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def bitwise(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def panel(family):
    rng = np.random.default_rng(FAMILIES.index(family) + 20)
    n = N_HIST + 3 * K
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, n + 16):
        y[:, t] = 0.3 + 0.5 * y[:, t - 1] - 0.2 * y[:, t - 2] + e[:, t]
    y = y[:, 16:]
    if family == "arima":
        y = np.cumsum(y, axis=1)
    elif family == "holt_winters":
        y = 10.0 + 2.0 * np.sin(2 * np.pi * np.arange(n) / PERIOD) \
            + 0.3 * y
    offs = rng.normal(size=(S, n)) * 0.5 if family == "arx" else None
    return y, offs


def models(family):
    """The JAX package's model and the port's carried across."""
    rng = np.random.default_rng(5)
    if family == "arima":
        c = np.column_stack([
            rng.uniform(-0.1, 0.1, S), rng.uniform(0.2, 0.5, S),
            rng.uniform(-0.3, 0.0, S), rng.uniform(-0.4, 0.4, S),
            rng.uniform(-0.2, 0.2, S)])
        return (j_arima.ARIMAModel(2, 1, 2, jnp.asarray(c), True),
                mconv.arima_from_numpy(2, 1, 2, c, device="cpu"))
    if family == "ar":
        c0, phi = rng.uniform(0.1, 0.5, S), np.column_stack(
            [rng.uniform(0.3, 0.6, S), rng.uniform(-0.3, -0.1, S)])
        return (j_ar.ARModel(jnp.asarray(c0), jnp.asarray(phi)),
                mconv.autoregression_from_numpy(c0, phi, device="cpu"))
    if family == "arx":
        c0 = rng.uniform(0.1, 0.5, S)
        co = np.column_stack([rng.uniform(0.3, 0.6, S),
                              rng.uniform(-0.3, -0.1, S),
                              rng.normal(size=S), rng.normal(size=S)])
        return (j_arx.ARXModel(jnp.asarray(c0), jnp.asarray(co), 2, 1, True),
                mconv.arx_from_numpy(c0, co, 2, 1, True, device="cpu"))
    if family == "ewma":
        a = rng.uniform(0.2, 0.8, S)
        return (j_ewma.EWMAModel(jnp.asarray(a)),
                mconv.ewma_from_numpy(a, device="cpu"))
    a, b, g = (rng.uniform(0.1, 0.6, S) for _ in range(3))
    return (j_hw.HoltWintersModel("additive", PERIOD, jnp.asarray(a),
                                  jnp.asarray(b * 0.2), jnp.asarray(g)),
            mconv.holt_winters_from_numpy("additive", PERIOD, a, b * 0.2, g,
                                          device="cpu"))


def start(family, **kw):
    """Both packages' sessions on the family's history, private
    registries."""
    y, offs = panel(family)
    j_model, t_model = models(family)
    hist = y[:, :N_HIST]
    ho = None if offs is None else offs[:, :N_HIST]
    j_reg, t_reg = j_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    js = j_ss.ServingSession.start(
        j_model, hist, offsets=None if ho is None else jnp.asarray(ho),
        registry=j_reg, **{k: v[0] for k, v in kw.items()})
    ts = serving.ServingSession.start(
        t_model, hist, offsets=ho, registry=t_reg, device="cpu",
        **{k: v[1] for k, v in kw.items()})
    return js, ts, y, offs


def tick_offs(offs, t):
    return None if offs is None else offs[:, N_HIST + t]


def snapshot_counters(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("serving.")}


def check_heal_matches_jax(family):
    """Poison every fifth lane's state, one tick under the fault and one
    clean, then heal both sessions (``auto_order=False``): the same rows
    heal, the statuses agree exactly, the spliced lanes' state within
    1e-8 of each lane's largest entry (a refit's optimizer stops within
    its tolerance, not at one point), the other lanes keep their state
    bit for bit, and the next tick agrees.  ARX has no ring-history
    refit in either package."""
    js, ts, y, offs = start(family)
    for sess in (js, ts):
        mod = j_res if sess is js else resilience
        with mod.fault_injection("state_poison", lane_stride=5):
            sess.update(y[:, N_HIST], tick_offs(offs, 0))
        sess.update(y[:, N_HIST + 1], tick_offs(offs, 1))
    close(ts.lane_status, js.lane_status)
    rows = np.arange(S)[::5]
    assert (ts.lane_status[rows] == health.LANE_DIVERGED).all()
    if family == "arx":
        for sess in (js, ts):
            try:
                sess.heal()
            except NotImplementedError as e:
                assert "ring-buffered" in str(e)
            else:
                raise AssertionError("an ARX session healed")
        return
    before = [t.clone() for t in ts._state]
    j_rep = js.heal(auto_order=False)
    t_rep = ts.heal(auto_order=False)
    assert t_rep == j_rep
    assert t_rep["healed"] == rows.size
    close(ts.lane_status, js.lane_status)
    keep = np.setdiff1d(np.arange(S), rows)
    for a, b in zip(ts._state, before):
        bitwise([a[keep].numpy()], [b[keep].numpy()])
    for got, want in ((ts._ssm, js._ssm), (ts._state, js._state)):
        for g, w in zip(got, want):
            g, w = g[rows].numpy(), np.asarray(w)[rows]
            if g.dtype.kind == "f" and g.size:
                # relative to each lane's largest entry: a covariance
                # entry that is zero up to rounding has no relative error
                big = np.abs(w).reshape(rows.size, -1).max(axis=1)
                big = big.reshape((-1,) + (1,) * (w.ndim - 1))
                assert (np.abs(g - w) <= HEAL_RTOL * big).all()
            else:
                np.testing.assert_array_equal(g, w)
    assert snapshot_counters(ts._reg)["serving.healed"] == rows.size
    t_next = ts.update(y[:, N_HIST + 2], tick_offs(offs, 2))
    j_next = js.update(y[:, N_HIST + 2], tick_offs(offs, 2))
    close(t_next.status, j_next.status)
    close(t_next.innovations, j_next.innovations, HEAL_RTOL)
