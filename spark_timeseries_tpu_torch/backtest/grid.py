"""Candidate grids and rolling-origin schedules, the backtest planner
(counterpart of ``spark_timeseries_tpu/backtest/grid.py``).

A backtest sweep is a (family × order × horizon × origin) grid.  This
module holds the static half of that plan:

- :class:`Candidate` / :class:`CandidateGrid` — which (family, order)
  pairs compete, and at which forecast horizons they are scored;
- :func:`plan_origins` / :class:`OriginSchedule` — where the forecast
  origins sit, how much history the one-shot parameter fit sees
  (expanding prefix or sliding window), and the min-train floor;
- :data:`FAMILIES` — the per-family adapters (stream-fit kwargs,
  chunk-row extraction, batched-model rebuild, parameter counts) that
  let ``evaluate``/``api`` treat every family uniformly.

Everything here is host-side bookkeeping: tiny, hashable and
JSON-describable (``describe()``).  The one change from the JAX
package: ``rebuild`` takes the device the batched model goes to.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Candidate", "CandidateGrid", "OriginSchedule", "plan_origins",
           "FAMILIES", "FamilySpec", "default_grid"]


class Candidate(NamedTuple):
    """One competitor: a model family plus its (family-specific) order
    tuple — ``("arima", (p, d, q))``, ``("ar", (p,))``, ``("ewma", ())``."""
    family: str
    order: Tuple[int, ...]

    @property
    def label(self) -> str:
        inner = ",".join(str(v) for v in self.order)
        return f"{self.family}({inner})"

    @property
    def slug(self) -> str:
        """Filesystem-safe label."""
        inner = "-".join(str(v) for v in self.order)
        return f"{self.family}-{inner}" if self.order else self.family


class FamilySpec(NamedTuple):
    """Adapter making one model family grid-able.

    ``stream_kwargs(order)`` → the family statics ``engine.stream_fit``
    needs; ``row_width(order)`` → the flattened per-series coefficient
    width; ``rows_of(model)`` → ``(chunk_series, row_width)`` rows from
    one chunk's fitted model (tensors on the host); ``rebuild(order,
    rows, device)`` → the batched model a full ``(n_series, row_width)``
    host row matrix describes, on ``device`` (NaN rows = failed chunks;
    they forecast NaN and score +inf);
    ``n_params(order)`` → the parsimony key for champion tie-breaking;
    ``d_of(order)`` → the integration order the replay must difference
    out; ``min_train_floor(order)`` → the fewest training obs a fit of
    this order supports."""
    family: str
    order_len: int
    stream_kwargs: Callable[[Tuple[int, ...]], Dict[str, Any]]
    row_width: Callable[[Tuple[int, ...]], int]
    rows_of: Callable[[Any], np.ndarray]
    rebuild: Callable[[Tuple[int, ...], np.ndarray, Any], Any]
    n_params: Callable[[Tuple[int, ...]], int]
    d_of: Callable[[Tuple[int, ...]], int]
    min_train_floor: Callable[[Tuple[int, ...]], int]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _arima_rows(model) -> np.ndarray:
    coefs = _np(model.coefficients)
    return coefs.reshape(-1, coefs.shape[-1])


def _arima_rebuild(order, rows, device):
    from ..models.arima import ARIMAModel
    p, d, q = order
    return ARIMAModel(p, d, q, torch.from_numpy(rows).to(device), True)


def _ar_rows(model) -> np.ndarray:
    c = _np(model.c).reshape(-1, 1)
    coefs = _np(model.coefficients)
    return np.concatenate([c, coefs.reshape(c.shape[0], -1)], axis=1)


def _ar_rebuild(order, rows, device):
    from ..models.autoregression import ARModel
    return ARModel(c=torch.from_numpy(rows[:, 0].copy()).to(device),
                   coefficients=torch.from_numpy(
                       np.ascontiguousarray(rows[:, 1:])).to(device))


def _ewma_rows(model) -> np.ndarray:
    return _np(model.smoothing).reshape(-1, 1)


def _ewma_rebuild(order, rows, device):
    from ..models.ewma import EWMAModel
    return EWMAModel(smoothing=torch.from_numpy(rows[:, 0].copy())
                     .to(device))


FAMILIES: Dict[str, FamilySpec] = {
    "arima": FamilySpec(
        family="arima", order_len=3,
        stream_kwargs=lambda o: {"p": o[0], "d": o[1], "q": o[2],
                                 "include_intercept": True},
        row_width=lambda o: 1 + o[0] + o[2],
        rows_of=_arima_rows,
        rebuild=_arima_rebuild,
        n_params=lambda o: 1 + o[0] + o[2],
        d_of=lambda o: o[1],
        # differencing burn-in + CSS residual window + a solve's worth
        # of rows per estimated parameter
        min_train_floor=lambda o: o[1] + 2 * max(o[0], o[2]) + 4 * (
            1 + o[0] + o[2])),
    "ar": FamilySpec(
        family="ar", order_len=1,
        stream_kwargs=lambda o: {"max_lag": o[0]},
        row_width=lambda o: 1 + o[0],
        rows_of=_ar_rows,
        rebuild=_ar_rebuild,
        n_params=lambda o: 1 + o[0],
        d_of=lambda o: 0,
        min_train_floor=lambda o: 4 * (1 + o[0]) + o[0]),
    "ewma": FamilySpec(
        family="ewma", order_len=0,
        stream_kwargs=lambda o: {},
        row_width=lambda o: 1,
        rows_of=_ewma_rows,
        rebuild=_ewma_rebuild,
        n_params=lambda o: 1,
        d_of=lambda o: 0,
        min_train_floor=lambda o: 8),
}


def _normalize_order(family: str, order) -> Tuple[int, ...]:
    spec = FAMILIES.get(family)
    if spec is None:
        raise ValueError(
            f"unknown backtest family {family!r}; supported: "
            f"{sorted(FAMILIES)} (families must have a state-space "
            f"form the origin replay can pin a gain for)")
    if order is None or order == ():
        tup: Tuple[int, ...] = ()
    elif isinstance(order, int):
        tup = (order,)
    else:
        tup = tuple(int(v) for v in order)
    if len(tup) != spec.order_len:
        raise ValueError(
            f"family {family!r} takes a length-{spec.order_len} order, "
            f"got {order!r}")
    if any(v < 0 for v in tup):
        raise ValueError(f"negative order terms in {family}{tup}")
    if family == "arima" and tup[0] == 0 and tup[2] == 0 and tup[1] == 0:
        raise ValueError("arima(0,0,0) has no dynamics to evaluate; "
                         "drop it from the grid")
    return tup


class CandidateGrid:
    """The competitors and scoring horizons of one backtest sweep.

    ``families`` maps family name → iterable of orders (``arima``:
    ``(p, d, q)`` triples; ``ar``: ``p`` ints or ``(p,)`` tuples;
    ``ewma``: a single empty order, spelled ``[()]`` or ``True``).
    ``horizons`` are the 1-based forecast steps candidates are scored
    at (tables cover every step up to ``max(horizons)``; the champion
    score averages the listed steps only).
    """

    def __init__(self, families: Dict[str, Any],
                 horizons: Sequence[int] = (1, 4, 8)):
        if not families:
            raise ValueError("CandidateGrid needs at least one family")
        cands = []
        for family, orders in families.items():
            if orders is True:
                orders = [()]
            if isinstance(orders, (int, tuple)):
                orders = [orders]
            orders = list(orders)
            if not orders:
                raise ValueError(f"family {family!r} lists no orders")
            for o in orders:
                cands.append(Candidate(family, _normalize_order(family, o)))
        if len(set(cands)) != len(cands):
            dupes = sorted({c.label for c in cands
                            if cands.count(c) > 1})
            raise ValueError(f"duplicate grid candidates: {dupes}")
        hs = tuple(sorted({int(h) for h in horizons}))
        if not hs or hs[0] < 1:
            raise ValueError(
                f"horizons must be >= 1 forecast steps, got {horizons!r}")
        self.candidates: Tuple[Candidate, ...] = tuple(cands)
        self.horizons: Tuple[int, ...] = hs

    @property
    def horizon(self) -> int:
        return self.horizons[-1]

    def __len__(self) -> int:
        return len(self.candidates)

    def __iter__(self):
        return iter(self.candidates)

    def min_train_floor(self) -> int:
        """The fewest training obs EVERY candidate's fit supports."""
        return max(FAMILIES[c.family].min_train_floor(c.order)
                   for c in self.candidates)

    def describe(self) -> Dict[str, Any]:
        """JSON-able grid description (reports)."""
        return {"candidates": [[c.family, list(c.order)]
                               for c in self.candidates],
                "horizons": list(self.horizons)}

    def __repr__(self) -> str:
        labels = ", ".join(c.label for c in self.candidates)
        return f"CandidateGrid([{labels}], horizons={self.horizons})"


def default_grid(horizons: Sequence[int] = (1, 4, 8)) -> CandidateGrid:
    """A modest general-purpose grid: AR(1)/AR(2) for autoregressive
    level series, ARMA(1,0,1)/ARIMA(1,1,1) for mixed/integrated
    dynamics, EWMA for local-level streams."""
    return CandidateGrid({"ar": [1, 2],
                          "arima": [(1, 0, 1), (1, 1, 1)],
                          "ewma": True}, horizons=horizons)


class OriginSchedule(NamedTuple):
    """Where the rolling origins sit and what the one-shot parameter fit
    may see.

    ``origins[j] = t`` means: forecast conditioning on the first ``t``
    observations, scoring against observations ``t .. t+horizon-1``
    (0-based).  Parameters are estimated ONCE per (candidate, series) on
    ``fit_window()`` — the expanding prefix ``[0, origins[0])`` or, in
    sliding mode, the trailing ``window`` obs ``[origins[0]-window,
    origins[0])`` — and the *state* conditioning always expands (the
    filter replay sees every observation before the origin; see
    docs/design.md §9 for the replay-vs-refit contract)."""
    origins: np.ndarray          # (n_origins,) int64, strictly increasing
    horizon: int
    mode: str                    # "expanding" | "sliding"
    min_train: int
    window: Optional[int]        # sliding-mode fit-window length
    n_obs: int

    @property
    def n_origins(self) -> int:
        return int(self.origins.size)

    def fit_window(self) -> Tuple[int, int]:
        """``(start, stop)`` of the parameter-estimation slice."""
        stop = int(self.origins[0])
        if self.mode == "sliding":
            return stop - int(self.window), stop
        return 0, stop

    def describe(self) -> Dict[str, Any]:
        return {"origins": [int(t) for t in self.origins],
                "horizon": int(self.horizon), "mode": self.mode,
                "min_train": int(self.min_train),
                "window": None if self.window is None else int(self.window),
                "n_obs": int(self.n_obs)}


def plan_origins(n_obs: int, horizon: int, *, n_origins: int = 8,
                 stride: Optional[int] = None,
                 min_train: Optional[int] = None,
                 mode: str = "expanding",
                 window: Optional[int] = None) -> OriginSchedule:
    """Plan a rolling-origin schedule over an ``n_obs``-long panel.

    Origins are placed as late as possible — the last origin leaves
    exactly ``horizon`` obs to score against — and walk backwards:
    evenly spaced between ``min_train`` (default ``n_obs // 2``) and
    ``n_obs - horizon`` when ``stride`` is None, else every ``stride``
    obs until ``n_origins`` are placed or the min-train floor stops
    them.  ``mode="sliding"`` caps the parameter-fit window at
    ``window`` (default ``min_train``) trailing obs instead of the whole
    prefix — a drift guard for long histories; the state conditioning
    expands either way.
    """
    n_obs = int(n_obs)
    horizon = int(horizon)
    n_origins = int(n_origins)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    if n_origins < 1:
        raise ValueError(f"n_origins must be >= 1, got {n_origins}")
    if mode not in ("expanding", "sliding"):
        raise ValueError(f"unknown origin-schedule mode {mode!r}; "
                         f"expected 'expanding' or 'sliding'")
    floor = n_obs // 2 if min_train is None else int(min_train)
    last = n_obs - horizon
    if last < floor or floor < 2:
        raise ValueError(
            f"cannot place any origin: n_obs={n_obs} leaves last origin "
            f"{last} under the min-train floor {floor} (horizon="
            f"{horizon}); shorten the horizon, lower min_train, or "
            f"bring more history")
    if stride is None:
        if n_origins == 1:
            # linspace(num=1) yields only the START point; the contract
            # is origins pack LATE — a single holdout sits at the end
            origins = np.array([last], dtype=np.int64)
        else:
            origins = np.unique(np.linspace(floor, last, num=n_origins,
                                            dtype=np.int64))
    else:
        stride = int(stride)
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        origins = np.array(sorted(last - k * stride
                                  for k in range(n_origins)
                                  if last - k * stride >= floor),
                           dtype=np.int64)
    if mode == "sliding":
        window = floor if window is None else int(window)
        if window < 2 or window > int(origins[0]):
            raise ValueError(
                f"sliding window {window} must lie in [2, first origin "
                f"{int(origins[0])}]")
    else:
        window = None
    return OriginSchedule(origins=origins, horizon=horizon, mode=mode,
                          min_train=floor, window=window, n_obs=n_obs)
