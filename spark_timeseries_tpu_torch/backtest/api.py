"""``backtest_panel``: the rolling-origin model-selection front door
(counterpart of ``spark_timeseries_tpu/backtest/api.py``).

One call answers "which model family and order is best for each of my
series, on out-of-sample evidence" (``auto_fit_panel`` ranks by
in-sample AIC only):

1. plan the origins (``grid.plan_origins``: expanding or sliding fit
   window, min-train floor);
2. fit every grid candidate ONCE per series on the fit window, each
   candidate streamed through ``engine.stream_fit`` chunks on the
   device (arima candidates: one ``arma_lm_fit`` launch a chunk on the
   card); panels of ultra-long series route arima candidates through
   ``longseries.fit_long`` instead;
3. replay every origin through the pinned-gain filter path and score
   sMAPE / MASE / RMSE / interval coverage on the device, NaN-masked
   (``evaluate.evaluate_candidate``);
4. crown a per-series champion: lowest ``select_by`` score, with
   statistical near-ties (a mean *paired per-origin* score excess within
   ``tie_z`` paired standard errors, plus a ``tie_tol`` relative floor)
   broken toward fewer parameters, then grid order (host numpy,
   ``_select_champions``).

Returns a :class:`BacktestReport`: per-series champions, per-horizon
error tables, per-origin dispersion (the error bars), and a stable
content digest.  ``journal=dir`` arms one crash-consistent journal per
candidate (``dir/cand-XX-<slug>``), so a killed sweep rerun with the same
arguments resumes its committed fits and reproduces the report bit for
bit; ``deadline_s``, ``retry`` and ``degrade`` are the engine's
per-chunk watchdog, chunk re-dispatch policy and OOM halving.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import is_device_fault, resolve_device
from ..utils import metrics as _metrics
from ..utils.durability import JournalSpecMismatch, as_backoff
from .evaluate import CandidateEval, evaluate_candidate
from .grid import (FAMILIES, Candidate, CandidateGrid, OriginSchedule,
                   default_grid, plan_origins)

__all__ = ["backtest_panel", "BacktestReport"]


class BacktestReport(NamedTuple):
    """The scorecard of one backtest sweep.

    ``champion[i]`` indexes ``candidates`` (−1 when every candidate
    failed on lane ``i``); ``scores_smape``/``scores_mase`` are
    ``(S, C)`` per-series per-candidate scores over the listed horizons;
    ``score_std`` the per-origin standard error of the ``select_by``
    score (honest error bars — forecast-accuracy estimates without
    origin dispersion overstate certainty); ``smape``/``mase``/``rmse``/
    ``coverage`` the full ``(S, C, H)`` per-horizon tables (horizons
    1..H); ``sigma2`` each candidate's calibrated innovation variance.
    """
    candidates: Tuple[Candidate, ...]
    horizons: Tuple[int, ...]
    schedule: OriginSchedule
    select_by: str
    tie_tol: float
    tie_z: float
    mase_m: int               # MASE scaling period (1 = lag-1 naive)
    champion: np.ndarray          # (S,) int64, -1 = no finite candidate
    scores_smape: np.ndarray      # (S, C)
    scores_mase: np.ndarray       # (S, C)
    score_std: np.ndarray         # (S, C)
    smape: np.ndarray             # (S, C, H)
    mase: np.ndarray              # (S, C, H)
    rmse: np.ndarray              # (S, C, H)
    coverage: np.ndarray          # (S, C, H)
    sigma2: np.ndarray            # (S, C)
    n_params: np.ndarray          # (C,)
    stream_stats: Tuple[Dict[str, Any], ...]

    @property
    def n_series(self) -> int:
        return int(self.champion.size)

    @property
    def scores(self) -> np.ndarray:
        """The ``(S, C)`` score matrix champions were selected on."""
        return (self.scores_smape if self.select_by == "smape"
                else self.scores_mase)

    def champion_for(self, i: int) -> Optional[Candidate]:
        ci = int(self.champion[i])
        return None if ci < 0 else self.candidates[ci]

    def champion_counts(self) -> Dict[str, int]:
        """How many series each candidate won (``"<none>"`` = dead)."""
        out: Dict[str, int] = {}
        for ci in self.champion:
            label = "<none>" if ci < 0 else self.candidates[int(ci)].label
            out[label] = out.get(label, 0) + 1
        return out

    def champion_score(self, metric: Optional[str] = None) -> np.ndarray:
        """``(S,)`` — each series' champion's score (NaN for dead
        lanes).  ``metric``: "smape" or "mase" (default: ``select_by``)."""
        metric = self.select_by if metric is None else metric
        table = {"smape": self.scores_smape,
                 "mase": self.scores_mase}[metric]
        out = np.full(self.champion.shape, np.nan, table.dtype)
        alive = self.champion >= 0
        out[alive] = table[np.nonzero(alive)[0], self.champion[alive]]
        return out

    def horizon_table(self, metric: str = "smape") -> np.ndarray:
        """``(H,)`` panel-mean per-horizon error of each series'
        champion — the "how fast does my best model degrade with
        horizon" curve."""
        table = {"smape": self.smape, "mase": self.mase,
                 "rmse": self.rmse, "coverage": self.coverage}[metric]
        alive = self.champion >= 0
        if not alive.any():
            return np.full((table.shape[-1],), np.nan, table.dtype)
        rows = table[np.nonzero(alive)[0], self.champion[alive]]
        return np.nanmean(rows, axis=0)

    def summary(self) -> Dict[str, Any]:
        cs = self.champion_score("smape")
        cm = self.champion_score("mase")
        return {
            "n_series": self.n_series,
            "n_candidates": len(self.candidates),
            "n_origins": self.schedule.n_origins,
            "horizons": list(self.horizons),
            "select_by": self.select_by,
            "mase_m": int(self.mase_m),
            "champion_counts": self.champion_counts(),
            "champion_smape": float(np.nanmean(cs))
            if np.isfinite(cs).any() else None,
            "champion_mase": float(np.nanmean(cm))
            if np.isfinite(cm).any() else None,
        }

    def digest(self) -> str:
        """Stable content hash of everything selection-relevant — two
        sweeps that agree here agree on every champion and every table
        (the kill-9 resume test's bitwise pin)."""
        h = hashlib.sha256()
        h.update(repr([c.label for c in self.candidates]).encode())
        h.update(repr(self.schedule.describe()).encode())
        h.update(repr((self.select_by, float(self.tie_tol),
                       float(self.tie_z), int(self.mase_m),
                       self.horizons)).encode())
        for arr in (self.champion, self.scores_smape, self.scores_mase,
                    self.score_std, self.smape, self.mase, self.rmse,
                    self.coverage, self.sigma2):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()

    def __repr__(self) -> str:
        counts = ", ".join(f"{k}: {v}"
                           for k, v in sorted(self.champion_counts().items()))
        return (f"BacktestReport({self.n_series} series x "
                f"{len(self.candidates)} candidates x "
                f"{self.schedule.n_origins} origins; champions: {counts})")


def _launches(ss: Dict[str, Any]) -> int:
    """A fit's ``lm_fit_launches``: the fused path's count, or the sum
    over a staged stream's chunks."""
    n = ss.get("lm_fit_launches", 0)
    return int(sum(n)) if isinstance(n, list) else int(n)


def _fit_candidate_long(train: np.ndarray, cand: Candidate,
                        jdir: Optional[str], deadline_s, retry,
                        degrade: bool, dev):
    """Ultra-long route: arima candidates fit per series through the
    DARIMA split-and-combine tier (``longseries.fit_long``: its fused
    path, one ``arma_lm_fit`` launch a chunk of segments on the card, or
    with a durability knob its staged path, one journaled segment stream
    per series); the combined AR(n_ar) models stack into one batched
    ARIMAModel."""
    from ..longseries import fit_long
    from ..models.arima import ARIMAModel
    rows = []
    stats = {"path": "longseries", "journal_hits": 0, "journal_commits": 0,
             "lm_fit_launches": 0, "chunk_failures": 0}
    n_ar = None
    d = cand.order[1]
    for i in range(train.shape[0]):
        lf = fit_long(
            train[i], order=cand.order, warn=False,
            journal=os.path.join(jdir, f"s{i:05d}") if jdir else None,
            deadline_s=deadline_s, chunk_retry=retry, degrade=degrade,
            device=dev)
        rows.append(lf.model.coefficients.cpu().numpy().reshape(-1))
        n_ar = lf.model.p
        ss = lf.stream_stats or {}
        stats["journal_hits"] += int(ss.get("journal_hits", 0))
        stats["journal_commits"] += int(ss.get("journal_commits", 0))
        stats["lm_fit_launches"] += _launches(ss)
        stats["chunk_failures"] += int(ss.get("chunk_failures", 0))
    model = ARIMAModel(n_ar, d, 0, torch.from_numpy(
        np.stack(rows).astype(train.dtype)).to(dev), True)
    return model, stats


# families whose engine fit accepts NaN-padded ragged lanes (leading/
# trailing padding); everything else needs fully-observed lanes
_RAGGED_FIT_FAMILIES = ("arima", "ar")


def _fittable_lanes(train: np.ndarray, family: str) -> np.ndarray:
    """Which lanes this family's fit path can take as-is.

    Ragged-capable families accept contiguous valid windows (leading/
    trailing NaN padding); interior gaps violate the fit tier's data
    contract ("impute first") and would fail the WHOLE chunk, so gap
    lanes are gathered out and score as dead instead.  Non-ragged
    families (ewma) need fully-observed lanes."""
    f = np.isfinite(train)
    if family not in _RAGGED_FIT_FAMILIES:
        return f.all(axis=1)
    has = f.any(axis=1)
    n = train.shape[1]
    first = np.argmax(f, axis=1)
    last = n - 1 - np.argmax(f[:, ::-1], axis=1)
    span = last - first + 1
    return has & (f.sum(axis=1) == span)


def _fit_candidate(train: np.ndarray, cand: Candidate, idx: int,
                   schedule: OriginSchedule, *, engine, chunk_size: int,
                   journal: Optional[str], deadline_s, retry,
                   degrade: bool, long_threshold: int, dev):
    """One candidate's parameters for the whole panel, streamed on
    ``dev`` (journaled under ``journal/cand-XX-<slug>`` when
    ``journal`` is given).

    Lanes the family's fit path cannot take (interior gaps anywhere;
    any NaN for non-ragged families) are gathered out before the
    stream (one dirty lane must cost ITSELF its scores, not its whole
    chunk) and come back as NaN coefficient rows (NaN forecasts,
    masked metrics, never champion).  ``stats`` carries
    ``lm_fit_launches`` (the stream's, summed; 0 on the CPU)."""
    spec = FAMILIES[cand.family]
    jdir = os.path.join(journal, f"cand-{idx:02d}-{cand.slug}") \
        if journal else None
    if cand.family == "arima" and train.shape[1] >= long_threshold:
        return _fit_candidate_long(train, cand, jdir, deadline_s, retry,
                                   degrade, dev)
    from ..engine import default_engine
    eng = engine if engine is not None else default_engine()
    ok = _fittable_lanes(train, cand.family)
    n_skipped = int((~ok).sum())
    if not ok.any():
        raise ValueError(
            f"no lane of the fit window is fittable for "
            f"{cand.label}: every lane has interior gaps"
            + ("" if cand.family in _RAGGED_FIT_FAMILIES
               else " or missing ticks (this family has no ragged fit)")
            + " — impute first (Panel.fill)")
    sub = train if n_skipped == 0 else np.ascontiguousarray(train[ok])
    meta = {"tier": "backtest",
            "candidate": [cand.family, list(cand.order)],
            "schedule": schedule.describe()}
    # retry is the chunk re-dispatch policy only (a fits' RetryPolicy is
    # refused, as the JAX package refuses it)
    res = eng.stream_fit(
        sub, cand.family, chunk_size=int(chunk_size), collect=True,
        journal=jdir, job_meta=meta, deadline_s=deadline_s,
        retry=None if retry is None else as_backoff(retry),
        degrade=degrade, job_label=f"backtest:{cand.label}", device=dev,
        **spec.stream_kwargs(cand.order))
    width = spec.row_width(cand.order)
    rows = np.full((train.shape[0], width), np.nan, train.dtype)
    lane_ids = np.nonzero(ok)[0]
    for rng, m in zip(res.stats.get("collected_ranges") or [],
                      res.models):
        rows[lane_ids[rng[0]:rng[1]]] = \
            spec.rows_of(m).astype(train.dtype)
    stats = {"path": "stream", "n_chunks": res.n_chunks,
             "chunk_failures": len(res.chunk_failures),
             "lanes_skipped": n_skipped,
             "journal_hits": int(res.stats.get("journal_hits", 0)),
             "journal_commits": int(res.stats.get("journal_commits", 0)),
             "lm_fit_launches": _launches(res.stats)}
    return spec.rebuild(cand.order, rows, dev), stats


def _select_champions(origin_scores: np.ndarray, scores: np.ndarray,
                      n_params: np.ndarray, tie_tol: float,
                      tie_z: float) -> np.ndarray:
    """Lowest score wins; statistical near-ties break toward fewer
    parameters, then grid order.

    The tie test is *paired per origin*: a candidate ties the minimum
    when its mean per-origin score excess over the best candidate is
    within ``tie_z`` paired standard errors (origins are shared, so the
    common forecast-noise component cancels — exactly the dispersion
    the report's error bars publish) plus a ``tie_tol`` relative floor.
    Without the parsimony ply, a nested over-parameterized candidate
    (AR(2) on a true AR(1)) would win ~half the lanes on fit-noise
    alone; without the *paired* band, the fixed tolerance would have to
    straddle both the nested-fit noise and the genuine margin of a
    wrong-but-close family — a window that closes as grids grow."""
    sc = np.where(np.isfinite(scores), scores, np.inf)
    best_idx = np.argmin(sc, axis=1)
    best = sc[np.arange(sc.shape[0]), best_idx]
    alive = np.isfinite(best)
    best_o = np.take_along_axis(
        origin_scores, best_idx[:, None, None], axis=1)   # (S, 1, O)
    diff = origin_scores - best_o                          # (S, C, O)
    m = np.isfinite(diff)
    cnt = m.sum(axis=2)
    mean_d = np.where(m, diff, 0.0).sum(axis=2) / np.maximum(cnt, 1)
    var_d = np.where(m, (diff - mean_d[..., None]) ** 2,
                     0.0).sum(axis=2) / np.maximum(cnt, 1)
    se = np.sqrt(var_d) / np.sqrt(np.maximum(cnt, 1))
    band = float(tie_z) * se + float(tie_tol) * np.abs(best)[:, None]
    ties = np.isfinite(scores) & (cnt > 0) & (mean_d <= band)
    ties[np.arange(sc.shape[0]), best_idx] = True
    C = sc.shape[1]
    key = n_params.astype(np.float64)[None, :] * C \
        + np.arange(C, dtype=np.float64)[None, :]
    key = np.where(ties, key, np.inf)
    champ = np.argmin(key, axis=1).astype(np.int64)
    champ[~alive] = -1
    return champ


def backtest_panel(values, grid: Optional[CandidateGrid] = None, *,
                   horizons: Optional[Sequence[int]] = None,
                   n_origins: int = 8, stride: Optional[int] = None,
                   min_train: Optional[int] = None,
                   mode: str = "expanding", window: Optional[int] = None,
                   select_by: str = "mase", tie_tol: float = 1e-3,
                   tie_z: float = 2.0, mase_m: int = 1,
                   coverage: float = 0.9, replay: str = "pinned",
                   engine=None, chunk_size: int = 131072,
                   journal: Optional[str] = None,
                   deadline_s: Optional[float] = None, retry=None,
                   degrade: bool = True,
                   long_threshold: int = 500_000,
                   device=None) -> BacktestReport:
    """Rolling-origin backtest + per-series champion selection.

    ``values (n_series, n_obs)`` the raw panel (NaN = missing; masked
    out of every metric).  ``grid`` the
    :class:`~spark_timeseries_tpu.backtest.grid.CandidateGrid` of
    (family, order) competitors (default :func:`default_grid`);
    ``horizons`` overrides the grid's scoring horizons.

    Schedule knobs (→ :func:`~spark_timeseries_tpu.backtest.grid.
    plan_origins`): ``n_origins``/``stride``/``min_train``, and
    ``mode="sliding"`` with ``window`` to cap the parameter-fit window.
    Selection knobs: ``select_by`` ("mase" — scale-free, the default —
    or "smape"); ``tie_z``/``tie_tol`` shape the statistical near-tie
    band the parsimony tie-break applies inside (``tie_z`` paired
    per-origin standard errors plus a ``tie_tol`` relative floor — see
    docs/design.md §9 champion tie-breaking); ``mase_m`` the MASE
    scaling period (1 = lag-1 naive; pass the seasonal period to scale
    by the seasonal-naive in-sample MAE — Hyndman & Koehler's seasonal
    MASE — so seasonal panels compete on a denominator their
    seasonality doesn't inflate); ``coverage`` the nominal interval
    level the coverage metric tests; ``replay`` ("pinned" | "refilter"
    — the sequential oracle, O(origins) slower, for verification).

    Streaming knobs pass to ``engine.stream_fit`` per candidate:
    ``engine`` (a :class:`~spark_timeseries_tpu_torch.engine.FitEngine`,
    default the process engine), ``chunk_size``, ``deadline_s``,
    ``retry`` (the chunk re-dispatch policy: an int or a
    ``BackoffPolicy``, not the fits' ``RetryPolicy``) and ``degrade``;
    ``journal=dir`` arms one crash-consistent journal per candidate
    under ``dir/cand-XX-<slug>``, so a killed sweep rerun with the same
    arguments resumes committed fits (``journal_hits`` in
    ``stream_stats``) and reproduces a digest-identical report.  Panels
    with ``n_obs >= long_threshold`` route arima candidates through
    ``longseries.fit_long`` (with a durability knob, one journaled
    segment stream per series).

    Runs on ``device`` (``None`` means CUDA, float32; ``device="cpu"``
    float32 or float64).  A candidate whose fit raises scores as dead
    on every lane (``stream_stats[i]["path"] == "failed"``), except for
    a kernel or card fault, which raises, and a journal that belongs to
    another sweep (``JournalSpecMismatch``), which raises.
    """
    if select_by not in ("smape", "mase"):
        raise ValueError(f"select_by must be 'smape' or 'mase', got "
                         f"{select_by!r} (rmse/coverage are table "
                         f"metrics, not selection scores)")
    if tie_tol < 0 or tie_z < 0:
        raise ValueError(f"tie_tol/tie_z must be >= 0, got "
                         f"{tie_tol}/{tie_z}")
    mase_m = int(mase_m)
    if mase_m < 1:
        # fail before the first candidate's full streamed fit
        raise ValueError(f"mase_m must be a period >= 1, got {mase_m}")
    if replay not in ("pinned", "refilter"):
        # fail before the first candidate's full streamed fit, not after
        raise ValueError(f"unknown replay mode {replay!r}; expected "
                         f"'pinned' or 'refilter'")
    dev = resolve_device(device)
    host = values.detach().cpu().numpy() \
        if isinstance(values, torch.Tensor) else np.asarray(values)
    if host.ndim == 1:
        host = host[None, :]
    if host.ndim != 2:
        raise ValueError(f"backtest_panel needs an (n_series, n_obs) "
                         f"panel, got {host.shape}")
    if not np.issubdtype(host.dtype, np.floating):
        host = host.astype(np.float32)
    S, n = host.shape

    if grid is None:
        grid = default_grid() if horizons is None \
            else default_grid(horizons)
    elif horizons is not None:
        grid = CandidateGrid(
            {**_group_orders(grid)}, horizons=horizons)
    schedule = plan_origins(n, grid.horizon, n_origins=n_origins,
                            stride=stride, min_train=min_train,
                            mode=mode, window=window)
    fs, ft = schedule.fit_window()
    floor = grid.min_train_floor()
    if ft - fs < floor:
        raise ValueError(
            f"fit window [{fs}, {ft}) is too short for the grid: the "
            f"widest candidate needs >= {floor} training obs — raise "
            f"min_train/window or shrink the candidate orders")

    reg = _metrics.get_registry()
    cands = tuple(grid.candidates)
    with _metrics.span("backtest.backtest_panel"):
        train = host[:, fs:ft]
        # the panel goes to the device once; every candidate scores on it
        vals = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
        evals: list[CandidateEval] = []
        stream_stats = []
        for ci, cand in enumerate(cands):
            with _metrics.span("backtest.fit"):
                try:
                    model, stats = _fit_candidate(
                        train, cand, ci, schedule, engine=engine,
                        chunk_size=chunk_size, journal=journal,
                        deadline_s=deadline_s, retry=retry,
                        degrade=degrade, long_threshold=long_threshold,
                        dev=dev)
                except Exception as e:  # noqa: BLE001 — candidate
                    # isolation: one family's fit path refusing the
                    # panel must cost that CANDIDATE its scores, not the
                    # whole sweep; a kernel or card fault raises, and so
                    # does a journal of another sweep (changed data or
                    # plan), whose refusal must stay loud
                    if is_device_fault(e) \
                            or isinstance(e, JournalSpecMismatch):
                        raise
                    reg.inc("backtest.candidate_failures")
                    spec = FAMILIES[cand.family]
                    rows = np.full(
                        (train.shape[0], spec.row_width(cand.order)),
                        np.nan, train.dtype)
                    model = spec.rebuild(cand.order, rows, dev)
                    stats = {"path": "failed",
                             "error": f"{type(e).__name__}: {e}"}
            evals.append(evaluate_candidate(
                vals, model, schedule, grid.horizons, replay=replay,
                coverage=coverage, mase_m=mase_m, device=dev))
            stream_stats.append(stats)

        scores_smape = np.stack([e.score_smape for e in evals], axis=1)
        scores_mase = np.stack([e.score_mase for e in evals], axis=1)
        sel = scores_smape if select_by == "smape" else scores_mase
        n_params = np.asarray([FAMILIES[c.family].n_params(c.order)
                               for c in cands], np.int64)
        origin_sel = np.stack([e.origin_smape if select_by == "smape"
                               else e.origin_mase for e in evals], axis=1)
        champion = _select_champions(origin_sel, sel, n_params, tie_tol,
                                     tie_z)

        # error bars from the SAME per-origin scores the tie band uses
        o_cnt = np.sum(np.isfinite(origin_sel), axis=2)      # (S, C)
        score_std = np.where(
            o_cnt > 1, _nanstd0(origin_sel) / np.sqrt(np.maximum(o_cnt, 1)),
            np.where(o_cnt > 0, 0.0, np.nan))

        report = BacktestReport(
            candidates=cands, horizons=grid.horizons, schedule=schedule,
            select_by=select_by, tie_tol=float(tie_tol),
            tie_z=float(tie_z), mase_m=mase_m,
            champion=champion, scores_smape=scores_smape,
            scores_mase=scores_mase, score_std=score_std,
            smape=np.stack([e.smape for e in evals], axis=1),
            mase=np.stack([e.mase for e in evals], axis=1),
            rmse=np.stack([e.rmse for e in evals], axis=1),
            coverage=np.stack([e.coverage for e in evals], axis=1),
            sigma2=np.stack([e.sigma2 for e in evals], axis=1),
            n_params=n_params, stream_stats=tuple(stream_stats))

        reg.inc("backtest.runs")
        reg.inc("backtest.candidates", len(cands))
        reg.inc("backtest.series", S)
        reg.inc("backtest.origins", schedule.n_origins)
        reg.inc("backtest.journal_hits",
                sum(s.get("journal_hits", 0) for s in stream_stats))
        dead = int(np.sum(champion < 0))
        if dead:
            reg.inc("backtest.dead_lanes", dead)
        cs = report.champion_score("smape")
        if np.isfinite(cs).any():
            reg.set_gauge("backtest.last_champion_smape",
                          float(np.nanmean(cs)))
    return report


def _nanstd0(x: np.ndarray) -> np.ndarray:
    """nanstd(axis=-1) without the all-NaN RuntimeWarning."""
    m = np.isfinite(x)
    cnt = np.maximum(m.sum(axis=-1), 1)
    mean = np.where(m, x, 0.0).sum(axis=-1) / cnt
    var = np.where(m, (x - mean[..., None]) ** 2, 0.0).sum(axis=-1) / cnt
    return np.sqrt(var)


def _group_orders(grid: CandidateGrid) -> Dict[str, Any]:
    """Regroup a grid's candidates family → order list (rebuilding the
    grid with overridden horizons)."""
    out: Dict[str, Any] = {}
    for c in grid.candidates:
        out.setdefault(c.family, []).append(c.order)
    return out
