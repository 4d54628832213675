"""`fit_long`: the ultra-long-series front door (counterpart of
``spark_timeseries_tpu/longseries/api.py``).

One call turns a single 10⁶–10⁸-observation series into work the
batched fits already do:

1. **difference globally** (``split.difference``: one common ``d``, so
   every segment estimates a pure ARMA in one parameter space);
2. **split the obs axis** (``split.segment_panel`` via
   ``stats.segment_plan``) into an ``(n_segments, window)`` panel;
3. **fit segments as a batch**: fused (``combine.fused_fit_combine``,
   one LM-fit launch a chunk of segments on the card, the combination
   folded in on the device), staged through ``engine.stream_fit`` (with
   its whole durability tier: journal and resume, per-chunk deadlines,
   chunk retries, OOM halving), or,
   with ``auto=True``, through ``models.arima.auto_fit_panel``
   (per-segment (p, q) selection: DARIMA's heterogeneous-order mode);
4. **combine by WLS** in the common AR-truncation space
   (``longseries.combine``);
5. **forecast exactly**: the combined AR model converts through
   ``statespace.to_statespace`` and the forecast-origin filter state
   over the FULL series is recovered in logarithmic depth by
   ``statespace.kalman.filter_forecast_origin``, so
   :meth:`LongSeriesFit.forecast` agrees with the sequential Kalman
   filter run over every observation.

The durability knobs (``journal``, ``deadline_s``, ``chunk_retry``,
``degrade=False``) select the staged path, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import check_dtype, resolve_device
from ..stats import SegmentPlan, segment_plan
from ..utils import metrics as _metrics
from ..utils.durability import as_backoff
from . import combine as _combine
from . import split as _split

__all__ = ["fit_long", "LongSeriesFit", "FusedDurabilityError"]


class FusedDurabilityError(ValueError):
    """``fused=True`` was combined with a durability/streaming knob the
    fused fit→combine path cannot honor (``journal``, ``deadline_s``,
    ``chunk_retry``, ``engine``, ``degrade=False``, or ``auto=True``,
    which is its own dispatch): the JAX package's refusal, kept so that
    a caller learns it before anything else."""


# default AR-truncation length when the order carries an MA part: the
# tail decays at the MA root rate, so 12 terms put the truncation error
# below f32 resolution for |θ| ≲ 0.4; pure-AR orders map exactly at
# n_ar = p
DEFAULT_MA_TRUNCATION = 12

# segments per chunk: big enough to fill the card, small enough that
# chunk × window × n_ar stays a few GB at 10⁸-obs scale
DEFAULT_CHUNK_SEGMENTS = 512

class LongSeriesFit:
    """A combined ultra-long fit: the global AR model, the split
    geometry, per-segment accounting, and exact forecasting.

    ``model`` is a standard
    :class:`~spark_timeseries_tpu_torch.models.arima.ARIMAModel`, an
    AR(``n_ar``) with the original ``d``, on the fit's device."""

    def __init__(self, model, plan: SegmentPlan,
                 combined: _combine.CombinedResult,
                 diffed: np.ndarray, ring: np.ndarray,
                 stream_stats: Optional[Dict[str, Any]] = None,
                 segment_orders: Optional[np.ndarray] = None,
                 warm: int = 512, origin_chunk: int = 65536):
        self.model = model
        self.plan = plan
        self.combined = combined
        self.sigma2 = combined.sigma2
        self.stream_stats = stream_stats
        self.segment_orders = segment_orders
        self._diffed = diffed
        self._dtype = diffed.dtype
        self._ring = ring
        self._warm = int(warm)
        self._origin_chunk = int(origin_chunk)
        self._origin_cache = None

    # -- introspection ------------------------------------------------------

    @property
    def coefficients(self):
        return self.model.coefficients

    @property
    def diagnostics(self):
        return self.model.diagnostics

    def describe(self) -> Dict[str, Any]:
        return {
            "order": (self.model.p, self.model.d, self.model.q),
            "n_obs": int(self.plan.head_drop + self.plan.n_used
                         + self.model.d),
            "n_segments": self.plan.n_segments,
            "seg_len": self.plan.seg_len,
            "overlap": self.plan.overlap,
            "head_drop": self.plan.head_drop,
            "segments_weighted": self.combined.n_weighted,
            "segments_finite": self.combined.n_finite,
            "segments_converged": self.combined.n_converged,
            "used_wls": self.combined.used_wls,
            "sigma2": self.sigma2,
        }

    # -- exact forecasting --------------------------------------------------

    def forecast_origin(self):
        """``(ssm, meta, origin)``: the exact forecast-origin
        :class:`~spark_timeseries_tpu_torch.statespace.ssm.FilterState`
        of the combined model over the **full** differenced series,
        recovered once (cached) by
        :func:`~spark_timeseries_tpu_torch.statespace.kalman.filter_forecast_origin`
        on the model's device: a short sequential covariance burn-in,
        then pinned-gain affine chunks in logarithmic depth.  Its ``ring``
        holds the raw-difference seeds, so the state is forecast-ready on
        the raw scale.  The differenced series (host) is released once
        the origin is cached."""
        if self._origin_cache is not None:
            return self._origin_cache
        from ..statespace.convert import to_statespace
        from ..statespace.kalman import filter_forecast_origin
        from ..statespace.ssm import SSMeta, initial_state

        ssm, meta = to_statespace(self.model)
        meta0 = SSMeta(meta.family, meta.mode, 0, meta.m)
        state0 = initial_state(ssm, meta0)
        ys = torch.from_numpy(self._diffed[None, :]).to(ssm.T.device)
        with _metrics.span("longseries.forecast_origin"):
            origin = filter_forecast_origin(
                ssm, state0, ys, meta0, warm=self._warm,
                chunk=self._origin_chunk)
        del ys
        origin = origin._replace(ring=torch.from_numpy(
            np.ascontiguousarray(self._ring[None, :])).to(ssm.T.device))
        self._origin_cache = (ssm, meta, origin)
        self._diffed = None
        return self._origin_cache

    def forecast(self, horizon: int) -> np.ndarray:
        """``(horizon,)`` point forecasts (host numpy) from the exact
        forecast-origin state: mean propagation with zero future
        innovations, integrated through the raw-difference ring, by the
        serving tier's forecast (``statespace.serving._forecast_impl``;
        a freshly recovered origin is an all-OK lane, so its health
        masks nothing)."""
        horizon = int(horizon)
        if horizon < 1:
            raise ValueError("forecast needs horizon >= 1")
        from ..statespace.health import HealthPolicy, initial_health
        from ..statespace.serving import _forecast_impl

        ssm, meta, origin = self.forecast_origin()
        offs = torch.zeros((1, horizon), dtype=ssm.T.dtype,
                           device=ssm.T.device)
        policy = HealthPolicy().validate()
        health = initial_health(origin)
        with _metrics.span("longseries.forecast"):
            out = _forecast_impl(meta, horizon, policy, ssm, origin, health,
                                 offs).cpu().numpy()
        return out[0]

    @property
    def loglik(self) -> float:
        """Exact σ²-concentrated Gaussian log-likelihood of the combined
        model over the differenced series (a by-product of the origin
        recovery; ``kalman.concentrated_loglik``, the convention of
        ``ARIMAModel.log_likelihood_exact``)."""
        from ..statespace.kalman import concentrated_loglik

        _, _, origin = self.forecast_origin()
        return float(concentrated_loglik(origin)[0])

    def __repr__(self) -> str:
        return (f"LongSeriesFit(AR({self.model.p}), d={self.model.d}, "
                f"segments={self.plan.n_segments}x{self.plan.window}, "
                f"weighted={self.combined.n_weighted})")


def _collect_segment_coefs(result, n_segments: int, dim: int,
                           dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Per-segment coefficient rows + converged flags from a
    ``StreamResult``, aligned through ``stats["collected_ranges"]``:
    failed chunks leave NaN rows (weight 0 in the combiner)."""
    coefs = np.full((n_segments, dim), np.nan, dtype)
    conv = np.zeros((n_segments,), bool)
    ranges = result.stats.get("collected_ranges") or []
    for (start, stop), model in zip(ranges, result.models):
        rows = model.coefficients.numpy().astype(dtype).reshape(-1, dim)
        coefs[start:stop] = rows
        diag = model.diagnostics
        if diag is not None:
            conv[start:stop] = diag.converged.numpy().reshape(-1)
    return coefs, conv


def fit_long(ts, order: Tuple[int, int, int] = (2, 1, 2),
             auto: bool = False, *,
             seg_len: Optional[int] = None, overlap: int = 0,
             n_ar: Optional[int] = None,
             max_p: int = 5, max_q: int = 5,
             engine=None, chunk_segments: int = DEFAULT_CHUNK_SEGMENTS,
             journal: Optional[str] = None,
             deadline_s: Optional[float] = None,
             chunk_retry=None, degrade: bool = True,
             fused: Optional[bool] = None,
             combine_chunk: int = 256,
             warm: int = 512, origin_chunk: int = 65536,
             device=None, **fit_kwargs) -> LongSeriesFit:
    """Fit one ultra-long series by DARIMA split-and-combine on
    ``device`` (``None`` means CUDA, float32; ``device="cpu"`` takes
    float32 or float64).

    ``ts (n,)``: a single fully-observed series (array or tensor; NaNs
    raise: impute first).  ``order = (p, d, q)``: ``d`` is applied
    globally before splitting; segments fit ARMA(p, q).  With
    ``auto=True`` each segment selects its own (p, q) ≤ (``max_p``,
    ``max_q``) through ``auto_fit_panel`` (``max_d=0``; on the card C + 1
    LM-fit launches over the whole segment panel); heterogeneous orders
    combine in the common AR-truncation space.

    Split geometry: ``seg_len``/``overlap`` feed
    :func:`~spark_timeseries_tpu_torch.stats.segment_plan` (default: the
    power of two near ``8·sqrt(n)``).  ``n_ar`` is the AR-truncation
    length of the combined model (default ``p`` for pure-AR orders,
    exact, else ``max(p + q, 12)``).

    Paths.  ``fused`` (default: on unless ``auto`` or ``engine`` is
    given) fits and combines chunk by chunk on the device
    (``combine.fused_fit_combine``); ``fused=False`` or ``engine=`` (a
    :class:`~spark_timeseries_tpu_torch.engine.FitEngine`) runs the
    staged path, ``engine.stream_fit`` over the segment panel in chunks
    of ``chunk_segments`` and then ``combine.combine_segments``: the
    same per-segment coefficients, bit for bit.  ``fit_kwargs``
    (``method``, ``max_iter``, ``include_intercept``, ``objective``) pass
    to the per-segment ``arima.fit`` (the auto path takes ``max_iter`` /
    ``screen_max_iter``); ``warn`` (default True) checks the combined
    model's stationarity.

    Durability: ``journal=path`` commits every segment chunk
    crash-consistently and a rerun resumes from it (the segmentation
    geometry joins the journal spec through ``job_meta``, so a changed
    split refuses resume), ``deadline_s`` / ``chunk_retry`` /
    ``degrade`` are the engine's per-chunk watchdog, chunk re-dispatch
    policy and OOM halving.  Each selects the staged path.

    Errors, in this order: a 2-D or NaN series and ``retry=`` raise
    ``ValueError`` (``retry`` is the fits' optimizer policy, which the
    segment stream does not route; ``chunk_retry`` is the chunk
    re-dispatch); ``fused=True`` with ``auto=True`` or with
    ``journal``, ``deadline_s``, ``chunk_retry``, ``engine`` or
    ``degrade=False`` raises :class:`FusedDurabilityError`, as in the
    JAX package; ``auto=True`` with any of those streaming knobs or a
    changed ``chunk_segments`` raises ``ValueError`` (the auto path
    never touches the stream).

    ``stream_stats`` of the result: the fused path's ``{"fused": True,
    "n_segments", "chunk_segments", "n_chunks", "lm_fit_launches"}``,
    the staged path's ``StreamResult.stats`` (``lm_fit_launches`` per
    chunk), the auto path's ``{"auto": True, "lm_fit_launches"}``.
    """
    host = ts.detach().cpu().numpy() if isinstance(ts, torch.Tensor) \
        else np.asarray(ts)
    if host.ndim != 1:
        raise ValueError(
            f"fit_long fits ONE ultra-long series, got shape "
            f"{host.shape}; for panels of normal-length series use "
            f"engine.stream_fit / fit_panel")
    if not np.issubdtype(host.dtype, np.floating):
        host = host.astype(np.float32)
    if np.isnan(host).any():
        raise ValueError(
            "fit_long needs a fully-observed series; impute missing "
            "ticks first (Panel.fill) — the segment combiner and the "
            "exact forecast-origin recovery both assume dense "
            "observations")
    p, d, q = (int(v) for v in order)
    if "retry" in fit_kwargs:
        raise ValueError(
            "fit_long does not take retry=: per-segment optimizer "
            "restarts are not routable through the segment stream (a "
            "failed segment combines at weight zero), and the JAX "
            "package's chunk re-dispatch policy is chunk_retry=")
    warn = bool(fit_kwargs.pop("warn", True))
    include_intercept = bool(fit_kwargs.get("include_intercept", True))
    icpt = 1 if include_intercept else 0

    forcing = [name for name, on in (
        ("journal", journal is not None),
        ("deadline_s", deadline_s is not None),
        ("chunk_retry", chunk_retry is not None),
        ("engine", engine is not None),
        ("degrade", degrade is not True)) if on]
    if fused is None:
        use_fused = not auto and not forcing
    elif fused:
        if auto:
            raise FusedDurabilityError(
                "fused=True with auto=True: the auto path is already "
                "one fused auto_fit_panel dispatch — drop fused= or "
                "use auto=False")
        if forcing:
            raise FusedDurabilityError(
                f"fused=True cannot honor the durability/streaming "
                f"knobs {forcing}: the fused fit→combine program never "
                f"touches stream_fit, so a journal would never commit "
                f"and a deadline would never arm — drop them or pass "
                f"fused=False for the staged (durable) path")
        use_fused = True
    else:
        use_fused = False
    dev = resolve_device(device)
    check_dtype(torch.from_numpy(host[:0]).dtype, dev)

    reg = _metrics.get_registry()
    with _metrics.span("longseries.fit_long"):
        diffed = _split.difference(host, d)
        plan = segment_plan(diffed.size, p if not auto else max_p,
                            q if not auto else max_q,
                            seg_len=seg_len, overlap=overlap)
        panel = _split.segment_panel(diffed, plan)
        K = plan.n_segments

        if n_ar is None:
            if auto:
                n_ar = max(max_p + max_q, DEFAULT_MA_TRUNCATION)
            else:
                n_ar = p if q == 0 else max(p + q, DEFAULT_MA_TRUNCATION)
        n_ar = int(n_ar)

        segment_orders = None
        stream_stats = None
        combined = None
        if auto:
            from ..models.arima import auto_fit_panel
            bad_kw = set(fit_kwargs) - {"max_iter", "screen_max_iter"}
            if bad_kw:
                raise ValueError(
                    f"auto=True routes segments through auto_fit_panel, "
                    f"which takes only max_iter/screen_max_iter; got "
                    f"{sorted(bad_kw)} (the grid always fits with an "
                    f"intercept and its own optimizer config)")
            # a journal that never commits must fail now, not at the
            # resume after a crash that finds nothing
            dead = [name for name, on in (
                ("journal", journal is not None),
                ("deadline_s", deadline_s is not None),
                ("chunk_retry", chunk_retry is not None),
                ("engine", engine is not None),
                ("degrade", degrade is not True),
                ("chunk_segments",
                 chunk_segments != DEFAULT_CHUNK_SEGMENTS)) if on]
            if dead:
                raise ValueError(
                    f"auto=True fits every segment in one fused "
                    f"auto_fit_panel dispatch; the streaming knobs "
                    f"{dead} have no effect there — drop them or use "
                    f"auto=False")
            st: dict = {}
            pf = auto_fit_panel(torch.from_numpy(panel), max_p=max_p,
                                max_d=0, max_q=max_q, device=dev, stats=st,
                                **fit_kwargs)
            cp, cq, c_icpt = max_p, max_q, True
            coefs = np.array(pf.coefficients, panel.dtype)
            conv = np.isfinite(np.asarray(pf.aic))
            # no-admissible-candidate lanes come back with aic=+inf but
            # ZERO coefficients: NaN them so the combiner drops them
            coefs[~conv] = np.nan
            segment_orders = pf.orders
            stream_stats = {"auto": True,
                            "lm_fit_launches": st["lm_fit_launches"]}
        elif use_fused:
            bad_kw = set(fit_kwargs) - {"method", "max_iter",
                                        "include_intercept", "objective"}
            if bad_kw:
                raise ValueError(
                    f"the fused fit→combine path takes only "
                    f"method/max_iter/include_intercept/objective; got "
                    f"{sorted(bad_kw)} (pass fused=False to route "
                    f"other fit kwargs through the staged path)")
            cp, cq, c_icpt = p, q, include_intercept
            step = max(1, min(int(chunk_segments), K))
            st = {}
            combined = _combine.fused_fit_combine(
                panel, p=p, q=q, include_intercept=include_intercept,
                n_ar=n_ar, overlap=plan.overlap, chunk_segments=step,
                method=str(fit_kwargs.get("method", "css-lm")),
                max_iter=fit_kwargs.get("max_iter"),
                objective=str(fit_kwargs.get("objective", "css")),
                device=dev, stats=st)
            stream_stats = {"fused": True, "n_segments": K,
                            "chunk_segments": step,
                            "n_chunks": st["n_chunks"],
                            "lm_fit_launches": st["lm_fit_launches"]}
        else:
            from ..engine import default_engine
            eng = engine if engine is not None else default_engine()
            cp, cq, c_icpt = p, q, include_intercept
            meta = {"tier": "longseries", "order": [p, d, q],
                    "seg_len": plan.seg_len, "overlap": plan.overlap,
                    "head_drop": plan.head_drop}
            # chunk_retry is the chunk re-dispatch policy only (a fits'
            # RetryPolicy is refused here as the JAX package refuses it)
            result = eng.stream_fit(
                panel, "arima", chunk_size=int(chunk_segments),
                collect=True, journal=journal, job_meta=meta,
                deadline_s=deadline_s,
                retry=None if chunk_retry is None
                else as_backoff(chunk_retry), degrade=degrade,
                job_label=f"longseries:arima({p},{d},{q})", device=dev,
                p=p, d=0, q=q, **fit_kwargs)
            stream_stats = dict(result.stats)
            stream_stats["n_chunks"] = result.n_chunks
            stream_stats["chunk_failures"] = len(result.chunk_failures)
            coefs, conv = _collect_segment_coefs(
                result, K, icpt + p + q, panel.dtype)

        if combined is None:
            combined = _combine.combine_segments(
                panel, coefs, conv, p=cp, q=cq,
                include_intercept=bool(c_icpt), n_ar=n_ar,
                overlap=plan.overlap, chunk_segments=int(combine_chunk),
                device=dev)

        from ..models.arima import ARIMAModel
        from ..models.base import FitDiagnostics
        n_w = combined.n_weighted
        tdt = torch.from_numpy(panel[:0]).dtype
        diags = FitDiagnostics(
            converged=torch.tensor(n_w > 0
                                   and 2 * combined.n_converged > n_w,
                                   device=dev),
            n_iter=torch.tensor(0, dtype=torch.int32, device=dev),
            fun=torch.tensor(combined.sigma2, dtype=tdt, device=dev))
        model = ARIMAModel(n_ar, d, 0,
                           torch.from_numpy(np.array(
                               combined.coefficients)).to(dev),
                           bool(c_icpt), diagnostics=diags)
        reg.inc("longseries.fits")
        reg.inc("longseries.segments", K)
        reg.set_gauge("longseries.last_n_obs", float(host.size))
    _warn(model, warn)
    return LongSeriesFit(model, plan, combined, diffed,
                         _split.tail_ring(host, d),
                         stream_stats=stream_stats,
                         segment_orders=segment_orders,
                         warm=warm, origin_chunk=origin_chunk)


def _warn(model, warn: bool) -> None:
    from ..models.arima import _warn_stationarity_invertibility
    _warn_stationarity_invertibility(model, bool(warn))
