"""Rolling-origin evaluation: fit once, replay every origin, score on the
device (counterpart of ``spark_timeseries_tpu/backtest/evaluate.py``).

The naive backtest refits one model per (candidate, series, origin).
This module replaces the refits with a *filter replay*:

1. parameters are estimated ONCE per (candidate, series) on the
   schedule's fit window (``engine.stream_fit`` upstream);
2. the fitted model converts to state-space form
   (``statespace.to_statespace``) and the sequential Kalman filter runs
   over the training prefix, converging the predicted covariance and
   calibrating σ² from the innovations;
3. the converged gain is pinned (``statespace.kalman.steady_gain``),
   which turns the remaining state recursion into an affine map:
   ``statespace.kalman.pinned_state_path`` evaluates every predicted
   state over the evaluation region in logarithmic depth, and each
   origin's forecast basis is ONE GATHERED ROW of that path;
4. h-step forecast means propagate from all origins at once (``x ← Tx +
   c``, read ``d + Zx``, integrate through the per-origin raw-difference
   ring), and sMAPE, MASE (scaled by the in-sample naive MAE), RMSE and
   empirical interval coverage are computed NaN-masked, so ragged or
   missing lanes score only real observations.

The JAX package jits each step; here each is a plain function on tensors
on the panel's device.  ``replay="refilter"`` swaps step 3 for the
oracle, a full sequential filter from scratch per origin (O(origins ·
n) filter steps): for tests and small checks only.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Tuple

import numpy as np
import torch

from .._device import check_dtype, resolve_device
from ..models.base import normal_quantile
from ..ops.univariate import differences_of_order_d
from ..utils import metrics as _metrics

if TYPE_CHECKING:
    from ..statespace.ssm import FilterState, SSMeta, StateSpace

# ``statespace`` is imported inside the functions: its quality plane
# imports :func:`masked_pointwise` from this module

__all__ = ["CandidateEval", "evaluate_candidate", "masked_pointwise"]

# families the replay supports: every family whose state-space form has
# no per-tick exogenous offsets and whose initial state needs no model
# internals (Holt-Winters seeds from its initial components)
REPLAY_FAMILIES = ("arima", "ar", "ewma")


class CandidateEval(NamedTuple):
    """One candidate's rolling-origin scorecard over a panel (host numpy).

    Tables are per-series per-horizon (``(S, H)``, horizons 1..H) masked
    means over origins; ``score_*`` collapse origins AND the schedule's
    listed horizons; ``origin_*`` are per-origin means over the listed
    horizons (the dispersion behind the report's error bars).  All NaN
    where no finite (forecast, actual) pair exists; ``forecasts`` are
    raw-scale point forecasts (``(S, O, H)``) and ``half`` the
    symmetric coverage-interval half-widths (``(S, H)``)."""
    forecasts: np.ndarray
    half: np.ndarray
    smape: np.ndarray
    mase: np.ndarray
    rmse: np.ndarray
    coverage: np.ndarray
    score_smape: np.ndarray
    score_mase: np.ndarray
    score_rmse: np.ndarray
    origin_smape: np.ndarray
    origin_mase: np.ndarray
    sigma2: np.ndarray


# ---------------------------------------------------------------------------
# the steps, as plain functions of tensors
# ---------------------------------------------------------------------------

# training prefixes longer than this many steps, fully observed, run in
# logarithmic depth (:func:`_train_state`)
SEQUENTIAL_PREFIX_MAX = 8192


def _train_state(ssm: StateSpace, state: FilterState, ys: torch.Tensor,
                 meta: SSMeta) -> FilterState:
    """The filter state after the training prefix ``ys (S, n)``.

    The JAX package scans the prefix sequentially inside one compiled
    program; here :func:`~spark_timeseries_tpu_torch.statespace.kalman.filter_panel`
    is a step loop of a few dozen launches a step, so a fully observed
    prefix longer than :data:`SEQUENTIAL_PREFIX_MAX` steps (the
    long-series route's: 5·10⁵ and more) runs in logarithmic depth
    instead: innovations-mode families by
    ``kalman.filter_panel_parallel`` (the same recursion), exact-mode
    ones by ``kalman.filter_forecast_origin`` (512 sequential steps,
    then the converged gain pinned), which match the sequential filter
    to rounding.  Shorter or gappy prefixes run the step loop."""
    from ..statespace.kalman import (filter_forecast_origin, filter_panel,
                                     filter_panel_parallel)
    if ys.shape[1] > SEQUENTIAL_PREFIX_MAX and bool(torch.isfinite(ys).all()):
        if meta.mode == "exact":
            return filter_forecast_origin(ssm, state, ys, meta)
        return filter_panel_parallel(ssm, state, ys, meta).state
    return filter_panel(ssm, state, ys, meta).state


def _propagate(ssm: StateSpace, states: torch.Tensor, rings: torch.Tensor,
               d: int, horizon: int) -> torch.Tensor:
    """h-step forecast means from a batch of origins at once.

    ``states (S, O, m)`` one-step-predicted origin states, ``rings
    (S, O, d)`` the last raw differences before each origin
    (``rings[..., j] = Δʲ y_{t-1}``).  Mean propagation with zero future
    innovations (``z = d + Z x``, ``x ← T(x) + c``), each step
    integrated back to the raw scale through the ring.  Returns ``(S, O,
    horizon)`` raw-scale forecasts."""
    x, lasts = states, rings
    Z = ssm.Z[:, None, :]                                    # (S, 1, m)
    T = ssm.T[:, None]                                       # (S, 1, m, m)
    c = ssm.c[:, None, :]
    outs = []
    for _ in range(int(horizon)):
        z = ssm.d[:, None] + (Z * x).sum(dim=-1)             # (S, O)
        if d:
            cur = z
            vals = []
            for j in range(d - 1, -1, -1):
                cur = cur + lasts[..., j]
                vals.append(cur)
            y_out = cur
            lasts = torch.stack(vals[::-1], dim=-1)
        else:
            y_out = z
        x = (T * x[..., None, :]).sum(dim=-1) + c
        outs.append(y_out)
    return torch.stack(outs, dim=-1)                         # (S, O, H)


def _replay(ssm: StateSpace, state: FilterState, ys_eval: torch.Tensor,
            oidx: torch.Tensor, rings: torch.Tensor, meta: SSMeta, d: int,
            horizon: int) -> torch.Tensor:
    """Pinned-gain origin replay: states over the eval region in
    logarithmic depth, one gathered row per origin, forecasts propagated
    from all origins at once."""
    from ..statespace.kalman import pinned_state_path, steady_gain
    if meta.mode == "exact":
        K, _ = steady_gain(ssm, state.P)
    else:
        K = ssm.gain
    path = pinned_state_path(ssm, state.a, ys_eval, K)   # (n_eval+1, S, m)
    states = path.index_select(0, oidx).movedim(0, 1)    # (S, O, m)
    return _propagate(ssm, states, rings, d, horizon)


def _half_widths(ssm: StateSpace, sigma2: torch.Tensor, meta: SSMeta,
                 d: int, horizon: int, conf: float) -> torch.Tensor:
    """Symmetric forecast-band half-widths for horizons 1..H, per lane.

    ψ weights on the filter scale: exact mode reads the noise loading
    off the unit-scale ``Q``'s first column (``Q = RRᵀ`` with ``R₀ = 1``,
    so ``Q[:, 0] = R`` and ``ψ_k = Z Tᵏ R``); innovations mode is ``ψ₀ =
    1, ψ_k = Z T^{k-1} gain``.  ``d`` integrations are ``d`` cumulative
    sums of the ψ sequence, then ``var_h = σ̂² Σ_{j<h} ψ̃_j²``."""
    psis = []
    if meta.mode == "exact":
        x = ssm.Q[:, :, 0]
        for _ in range(horizon):
            psis.append((ssm.Z * x).sum(dim=-1))
            x = (ssm.T * x[:, None, :]).sum(dim=-1)
    else:
        x = ssm.gain
        psis.append(torch.ones_like(sigma2))
        for _ in range(horizon - 1):
            psis.append((ssm.Z * x).sum(dim=-1))
            x = (ssm.T * x[:, None, :]).sum(dim=-1)
    psi = torch.stack(psis, dim=-1)                          # (S, H)
    for _ in range(d):
        psi = torch.cumsum(psi, dim=-1)
    var = sigma2[:, None] * torch.cumsum(psi * psi, dim=-1)
    z = normal_quantile(conf, sigma2.dtype).to(sigma2.device)
    return z * torch.sqrt(var)


def _masked_mean(pt: torch.Tensor, mask: torch.Tensor, dim) -> torch.Tensor:
    cnt = mask.sum(dim=dim)
    s = torch.where(mask, pt, torch.zeros((), dtype=pt.dtype,
                                          device=pt.device)).sum(dim=dim)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                       torch.full((), float("nan"), dtype=pt.dtype,
                                  device=pt.device))


def masked_pointwise(fcst: torch.Tensor, actual: torch.Tensor):
    """The NaN-masked pointwise error primitives every quality consumer
    shares: the metric tables here and the serving tier's online
    accuracy step (``statespace.quality.quality_step``).

    A point contributes only when both forecast and actual are finite;
    sMAPE's 0/0 (both sides zero, a perfect forecast of a zero)
    contributes 0.  Returns ``(mask, abserr, smape_pt)`` with masked-out
    points zeroed, at any broadcastable shape."""
    mask = torch.isfinite(actual) & torch.isfinite(fcst)
    zero = torch.zeros((), dtype=actual.dtype, device=actual.device)
    a = torch.where(mask, actual, zero)
    f = torch.where(mask, fcst, zero)
    abserr = (f - a).abs()
    denom = f.abs() + a.abs()
    pos = denom > 0
    smape_pt = torch.where(
        pos, 200.0 * abserr / torch.where(pos, denom, torch.ones_like(denom)),
        torch.zeros_like(abserr))
    return mask, abserr, smape_pt


def _metric_tables(fcst: torch.Tensor, actual: torch.Tensor,
                   half: torch.Tensor, scale: torch.Tensor,
                   hs: Tuple[int, ...]):
    """All four metric families in one NaN-masked pass.

    ``fcst``/``actual (S, O, H)``, ``half (S, H)``, ``scale (S,)`` the
    in-sample naive MAE (MASE denominator), ``hs`` the 1-based horizons
    the scores average."""
    mask, abserr, smape_pt = masked_pointwise(fcst, actual)
    ok_scale = torch.isfinite(scale) & (scale > 0)
    mase_pt = abserr / torch.where(ok_scale, scale,
                                   torch.ones_like(scale))[:, None, None]
    mase_mask = mask & ok_scale[:, None, None]
    sq_pt = abserr * abserr
    cover_pt = (abserr <= half[:, None, :]).to(abserr.dtype)

    smape_tab = _masked_mean(smape_pt, mask, 1)              # (S, H)
    mase_tab = _masked_mean(mase_pt, mase_mask, 1)
    rmse_tab = torch.sqrt(_masked_mean(sq_pt, mask, 1))
    cover_tab = _masked_mean(cover_pt, mask, 1)

    idx = torch.as_tensor([h - 1 for h in hs], device=fcst.device)
    sm_h = smape_pt.index_select(-1, idx)
    ms_h = mase_pt.index_select(-1, idx)
    sq_h = sq_pt.index_select(-1, idx)
    m_h = mask.index_select(-1, idx)
    mm_h = mase_mask.index_select(-1, idx)
    score_smape = _masked_mean(sm_h, m_h, (1, 2))            # (S,)
    score_mase = _masked_mean(ms_h, mm_h, (1, 2))
    score_rmse = torch.sqrt(_masked_mean(sq_h, m_h, (1, 2)))
    origin_smape = _masked_mean(sm_h, m_h, 2)                # (S, O)
    origin_mase = _masked_mean(ms_h, mm_h, 2)
    return (smape_tab, mase_tab, rmse_tab, cover_tab, score_smape,
            score_mase, score_rmse, origin_smape, origin_mase)


def _naive_scale(values: torch.Tensor, start: int, stop: int,
                 m_period: int) -> torch.Tensor:
    """In-sample naive MAE over the fit window (the MASE denominator),
    NaN pairs masked.  ``m_period = 1`` is the classic lag-1 scaling;
    ``m_period = m`` scales by the seasonal-naive forecast ``|y_t -
    y_{t-m}|`` (Hyndman & Koehler's seasonal MASE)."""
    w = values[:, start:stop]
    d1 = w[:, m_period:] - w[:, :-m_period]
    m = torch.isfinite(d1)
    cnt = m.sum(dim=1)
    s = torch.where(m, d1.abs(), torch.zeros((), dtype=d1.dtype,
                                             device=d1.device)).sum(dim=1)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1),
                       torch.full((), float("nan"), dtype=d1.dtype,
                                  device=d1.device))


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def _seeded_initial(ssm: StateSpace, meta0: SSMeta, family: str,
                    diffed: torch.Tensor):
    """Initial filter state + the index the train filter starts at.

    Exact-mode families start from the stationary prior at t = 0.  EWMA
    mirrors its converter's bootstrap: ``S_0 = y_0`` exactly, filtering
    from t = 1."""
    from ..statespace.ssm import initial_state
    state0 = initial_state(ssm, meta0)
    if family == "ewma":
        first = diffed[:, 0]
        a0 = torch.where(torch.isfinite(first), first,
                         torch.zeros_like(first))[:, None]
        return state0._replace(a=a0), 1
    return state0, 0


def evaluate_candidate(values, model, schedule, horizons, *,
                       replay: str = "pinned",
                       coverage: float = 0.9,
                       mase_m: int = 1, device=None) -> CandidateEval:
    """Score one fitted candidate over a panel's rolling origins.

    ``values (S, n)`` the raw panel (array or tensor); ``model`` the
    candidate's batched fitted model (one lane per series, on
    ``device``; NaN-coefficient lanes forecast NaN and score NaN → +inf
    downstream); ``schedule`` an
    :class:`~spark_timeseries_tpu_torch.backtest.grid.OriginSchedule`;
    ``horizons`` the 1-based steps the scores average.  ``replay``:
    ``"pinned"`` (the logarithmic-depth path) or ``"refilter"`` (the
    sequential per-origin oracle).  ``coverage`` sets the nominal level
    of the interval-coverage metric; ``mase_m`` the MASE scaling period.
    Runs on ``device`` (``None`` means CUDA); returns host numpy."""
    from ..statespace.convert import to_statespace
    from ..statespace.ssm import SSMeta, StateSpace
    if replay not in ("pinned", "refilter"):
        raise ValueError(f"unknown replay mode {replay!r}; expected "
                         f"'pinned' or 'refilter'")
    mase_m = int(mase_m)
    if mase_m < 1:
        raise ValueError(f"mase_m must be a period >= 1, got {mase_m}")
    dev = resolve_device(device)
    vals = values.to(dev) if isinstance(values, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(values)).to(dev)
    if vals.ndim != 2:
        raise ValueError(f"evaluate_candidate needs an (n_series, n_obs) "
                         f"panel, got {tuple(vals.shape)}")
    dtype = vals.dtype
    check_dtype(dtype, dev)
    ssm, meta = to_statespace(model)
    if meta.family not in REPLAY_FAMILIES:
        raise ValueError(
            f"family {meta.family!r} is not replayable; supported: "
            f"{REPLAY_FAMILIES}")
    ssm = StateSpace(*(leaf.to(device=dev, dtype=dtype) for leaf in ssm))
    d = meta.d_order
    meta0 = SSMeta(meta.family, meta.mode, 0, meta.m)
    origins = np.asarray(schedule.origins, np.int64)
    t0, t_last = int(origins[0]), int(origins[-1])
    H = int(schedule.horizon)
    hs = tuple(sorted({int(h) for h in horizons}))
    if hs[0] < 1 or hs[-1] > H:
        raise ValueError(f"horizons {hs} outside 1..{H}")
    if t0 - d < 2:
        raise ValueError(f"first origin {t0} leaves no differenced "
                         f"training prefix (d={d})")

    diffed = differences_of_order_d(vals, d)[..., d:]        # (S, n-d)
    state0, skip = _seeded_initial(ssm, meta0, meta.family, diffed)

    with _metrics.span("backtest.replay"):
        # training prefix: converge the covariance, calibrate σ²
        train = diffed[:, skip:t0 - d]
        origin0 = _train_state(ssm, state0, train, meta0)
        n_tr = torch.clamp(origin0.n_obs.to(dtype), min=1.0)
        sigma2 = origin0.ssq / n_tr
        sigma2 = torch.where(torch.isfinite(sigma2) & (sigma2 > 0),
                             sigma2, torch.ones_like(sigma2))

        # per-origin raw-difference rings: rings[..., j] = Δʲ y_{t-1}
        rings = vals.new_zeros((vals.shape[0], origins.size, d))
        level = vals
        for j in range(d):
            if j:
                level = level[:, 1:] - level[:, :-1]
            rings[..., j] = level[:, torch.from_numpy(origins - 1 - j)
                                  .to(dev)]

        if replay == "pinned" and t_last == t0:
            # single origin: nothing to replay past the training prefix
            fcst = _propagate(ssm, origin0.a[:, None, :], rings, d, H)
        elif replay == "pinned":
            ys_eval = diffed[:, t0 - d:t_last - d]
            oidx = torch.from_numpy(origins - t0).to(dev)
            fcst = _replay(ssm, origin0, ys_eval, oidx, rings, meta0, d, H)
        else:
            # oracle: one full sequential filter per origin
            states = [origin0.a]
            for t in origins[1:]:
                st = _train_state(ssm, state0, diffed[:, skip:int(t) - d],
                                  meta0)
                states.append(st.a)
            fcst = _propagate(ssm, torch.stack(states, dim=1), rings, d, H)

        half = _half_widths(ssm, sigma2, meta0, d, H, float(coverage))
        if dev.type == "cuda":
            # the span's time is the replay's, not the enqueue's
            torch.cuda.synchronize(dev)

    with _metrics.span("backtest.score"):
        idx = origins[:, None] + np.arange(H)[None, :]        # (O, H)
        actual = vals[:, torch.from_numpy(idx).to(dev)]       # (S, O, H)
        fs, ft = schedule.fit_window()
        if ft - fs <= mase_m:
            raise ValueError(
                f"mase_m={mase_m} leaves no seasonal-naive pair in the "
                f"[{fs}, {ft}) fit window — shrink the period or widen "
                f"the window")
        scale = _naive_scale(vals, int(fs), int(ft), mase_m)
        tabs = _metric_tables(fcst, actual, half, scale, hs)

    (smape_tab, mase_tab, rmse_tab, cover_tab, score_smape, score_mase,
     score_rmse, origin_smape, origin_mase) = (t.cpu().numpy()
                                               for t in tabs)
    return CandidateEval(
        forecasts=fcst.cpu().numpy(), half=half.cpu().numpy(),
        smape=smape_tab, mase=mase_tab, rmse=rmse_tab,
        coverage=cover_tab, score_smape=score_smape,
        score_mase=score_mase, score_rmse=score_rmse,
        origin_smape=origin_smape, origin_mase=origin_mase,
        sigma2=sigma2.cpu().numpy())
