"""Panel: a keyed panel of time series on one index, its values a tensor
on a device (counterpart of ``spark_timeseries_tpu/panel.py``).

Layout: series-major ``(n_series, n_obs)``, each series a contiguous
row.  The index and the keys stay on the host; calendar logic (index
arithmetic, key lookups) runs there, and only the integer locations it
resolves cross to the device, as index tensors for one gather.

Device and dtype: ``device=None`` means CUDA, and without a card the
constructor raises unless the caller passes ``device="cpu"``.  On CUDA
the values are float32, what every fit on the card takes (a float64
input is cast, as the JAX package's ``jnp.asarray`` casts it with x64
off).  On the CPU the values keep the input's dtype, so a float64 panel
stays float64.  An array is copied, as ``jnp.asarray`` copies it; a
tensor already on the panel's device in its dtype is taken as it is.
"""

from __future__ import annotations

from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ._device import resolve_device
from .ops import univariate as uv
from .ops.lag import lag_stack
from .ops.resample import resample as _resample_values
from .time import (DateTimeIndex, Frequency, IrregularDateTimeIndex,
                   UniformDateTimeIndex)
from .time.rebase import rebaser as _rebaser
from .utils import metrics as _metrics


def lagged_string_key(key: str, lag_order: int) -> str:
    """Key naming of lagged series: ``lag<k>(<key>)``, the key at lag 0."""
    return f"lag{lag_order}({key})" if lag_order > 0 else key


def lagged_pair_key(key: Any, lag_order: int) -> Tuple[Any, int]:
    """``(key, lag)`` key of lagged series."""
    return (key, lag_order)


def _waits_for(what: str, item: str):
    raise NotImplementedError(
        f"Panel.{what} is not ported yet (ROADMAP Queue A item {item})")


class Panel:
    """A keyed panel of univariate series sharing one ``DateTimeIndex``.

    Attributes:
      index: the shared time index (host).
      values: ``(n_series, n_obs)`` tensor on the panel's device.
      keys: list of per-series keys (host).
    """

    def __init__(self, index: DateTimeIndex, values, keys: Sequence[Any],
                 device=None):
        dev = resolve_device(device)
        if isinstance(values, torch.Tensor):
            t = values
        else:
            arr = np.asarray(values)
            # the panel owns its values, as the JAX Panel's jnp.asarray
            # copy does: a later change to the caller's array does not
            # reach it (a move to the card copies anyway)
            if (arr is values and dev.type == "cpu") or not (
                    arr.flags.c_contiguous and arr.flags.writeable):
                arr = np.array(arr, order="C")
            t = torch.from_numpy(arr)
        if t.ndim != 2:
            raise ValueError(
                f"values must be (n_series, n_obs), got {tuple(t.shape)}")
        if t.shape[1] != len(index):
            raise ValueError(
                f"values has {t.shape[1]} observations but index has "
                f"{len(index)} instants")
        if t.shape[0] != len(keys):
            raise ValueError(
                f"values has {t.shape[0]} series but {len(keys)} keys given")
        dtype = torch.float32 if dev.type == "cuda" else t.dtype
        if t.device != dev:
            if t.device.type == "cpu":
                _metrics.inc("panel.h2d_bytes",
                             t.numel() * torch.empty((), dtype=dtype)
                             .element_size())
            t = t.to(device=dev, dtype=dtype)
        else:
            t = t.to(dtype=dtype)
        self.index = index
        self.values = t
        self.keys = list(keys)

    # -- basic introspection ------------------------------------------------

    @property
    def n_series(self) -> int:
        return self.values.shape[0]

    @property
    def n_obs(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __len__(self) -> int:
        return self.n_series

    def __repr__(self) -> str:
        return (f"Panel(n_series={self.n_series}, n_obs={self.n_obs}, "
                f"index={self.index!r}, device={self.device})")

    def _with(self, values=None, index=None, keys=None) -> "Panel":
        return Panel(self.index if index is None else index,
                     self.values if values is None else values,
                     self.keys if keys is None else keys,
                     device=self.device)

    def _locs(self, locs: np.ndarray) -> torch.Tensor:
        """Host integer locations as an index tensor on the device."""
        return torch.from_numpy(np.asarray(locs, dtype=np.int64)).to(
            self.device)

    def _host(self) -> np.ndarray:
        return self.values.cpu().numpy()

    # -- distribution --------------------------------------------------------

    def shard(self, mesh, axis_name: str = "series") -> "Panel":
        """Spread the series over devices: waits for ``torch.distributed``."""
        _waits_for("shard", "8")

    def to_row_matrix(self) -> torch.Tensor:
        """Time-major ``(n_obs, n_series)`` matrix (``toRowMatrix``)."""
        return self.to_time_major()

    def to_indexed_row_matrix(self) -> torch.Tensor:
        """Alias of :meth:`to_row_matrix`; the row index is the position
        on the time axis."""
        return self.to_time_major()

    def to_time_major(self) -> torch.Tensor:
        """``(n_obs, n_series)`` view: the reference's ``toInstants``
        transpose."""
        return self.values.T

    # -- per-series iteration & lookup ---------------------------------------

    def __iter__(self) -> Iterator[Tuple[Any, np.ndarray]]:
        host = self._host()
        for i, k in enumerate(self.keys):
            yield k, host[i]

    def head(self) -> Tuple[Any, np.ndarray]:
        """First ``(key, series)`` pair."""
        return self.keys[0], self.values[0].cpu().numpy()

    def find_series(self, key: Any) -> np.ndarray:
        """The series of ``key``."""
        return self.values[self.keys.index(key)].cpu().numpy()

    def select(self, keys: Sequence[Any]) -> "Panel":
        """Sub-panel with the given keys, in the given order (a repeated
        panel key resolves to its first occurrence)."""
        pos: dict = {}
        for i, k in enumerate(self.keys):
            pos.setdefault(k, i)
        try:
            locs = np.fromiter((pos[k] for k in keys), dtype=np.int64,
                               count=len(keys))
        except KeyError as e:
            raise ValueError(f"{e.args[0]!r} is not in the panel keys") \
                from None
        return self._with(values=self.values[self._locs(locs)],
                          keys=list(keys))

    def filter_keys(self, predicate: Callable[[Any], bool]) -> "Panel":
        """Keep the series whose key satisfies ``predicate``."""
        locs = np.fromiter((i for i, k in enumerate(self.keys)
                            if predicate(k)), dtype=np.int64)
        return self._with(values=self.values[self._locs(locs)],
                          keys=[self.keys[i] for i in locs])

    def filter_start_with(self, prefix: str) -> "Panel":
        return self.filter_keys(lambda k: str(k).startswith(prefix))

    def filter_end_with(self, suffix: str) -> "Panel":
        return self.filter_keys(lambda k: str(k).endswith(suffix))

    def union(self, other: "Panel") -> "Panel":
        """Stack another panel's series on the same index."""
        if len(other.index) != len(self.index):
            raise ValueError("union requires identical index lengths")
        return self._with(values=torch.cat([self.values, other.values]),
                          keys=self.keys + other.keys)

    def add_series(self, key: Any, series) -> "Panel":
        return self.union(Panel(self.index, torch.as_tensor(series)[None, :],
                                [key], device=self.device))

    # -- time slicing --------------------------------------------------------

    def islice(self, start: int, end: int) -> "Panel":
        """Slice by integer location range [start, end)."""
        return self._with(values=self.values[:, start:end],
                          index=self.index.islice(start, end))

    def slice(self, start, end) -> "Panel":
        """Slice by datetimes, both ends inclusive."""
        lo = self.index.loc_at_or_after(start)
        hi = self.index.loc_at_or_before(end) + 1
        return self.islice(lo, hi)

    # -- elementwise / per-series transforms ---------------------------------

    def map_values(self, f: Callable[[torch.Tensor], torch.Tensor]
                   ) -> "Panel":
        """Apply an index-preserving batched transform to the values."""
        return self._with(values=f(self.values))

    def map_series(self, f: Callable[[torch.Tensor], torch.Tensor],
                   new_index: Optional[DateTimeIndex] = None) -> "Panel":
        """``torch.func.vmap`` a one-series function over the panel: ``f``
        takes ``(n,)`` and returns ``(m,)`` with ``m == len(new_index or
        index)``."""
        out = torch.func.vmap(f)(self.values)
        idx = self.index if new_index is None else new_index
        if out.shape[1] != len(idx):
            raise ValueError(
                f"mapped series length {out.shape[1]} != index size "
                f"{len(idx)}")
        return self._with(values=out, index=idx)

    def fill(self, method: str) -> "Panel":
        """NaN imputation (``linear``, ``nearest``, ``next``,
        ``previous``, ``spline`` (on the host), ``zero``)."""
        return self._with(values=uv.fillts(self.values, method))

    def differences(self, lag: int = 1) -> "Panel":
        """Order-``lag`` differencing, dropping the first ``lag``
        instants."""
        vals = self.values[:, lag:] - self.values[:, :-lag]
        return self._with(values=vals,
                          index=self.index.islice(lag, len(self.index)))

    def quotients(self, lag: int = 1) -> "Panel":
        return self._with(values=uv.quotients(self.values, lag),
                          index=self.index.islice(lag, len(self.index)))

    def price2ret(self) -> "Panel":
        """Periodic returns."""
        return self._with(values=uv.price2ret(self.values, 1),
                          index=self.index.islice(1, len(self.index)))

    return_rates = price2ret

    def roll_sum(self, window: int) -> "Panel":
        """Sliding sum; drops the first ``window - 1`` instants."""
        return self._with(values=uv.roll_sum(self.values, window),
                          index=self.index.islice(window - 1,
                                                  len(self.index)))

    def roll_mean(self, window: int) -> "Panel":
        return self._with(values=uv.roll_mean(self.values, window),
                          index=self.index.islice(window - 1,
                                                  len(self.index)))

    def differences_by_frequency(self, frequency: Frequency) -> "Panel":
        """Difference each series against its value one ``frequency``
        earlier, falling back to the most recent earlier observation.  If
        x[t] is NaN the output is NaN; if the looked-up earlier value is
        NaN, walk back to the most recent non-NaN of that series.  The
        calendar lookups run on the host; the walk-back is a cummax
        gather on the device."""
        zone = self.index.zone
        start_nanos = frequency.advance(self.index.first_nanos, 1, zone)
        start = self.index.loc_at_or_after(start_nanos)
        if start == 0:
            start = 1
        n = len(self.index)
        new_index = self.index.islice(start, n)
        # for each kept instant, the location of (t - frequency) at or
        # before it; -1 clamps to 0
        all_nanos = self.index.to_nanos_array()
        prev_nanos = frequency.advance_each(all_nanos[start:], -1, zone)
        prev_locs = np.maximum(self.index.locs_at_or_before(prev_nanos), 0)

        vals = self.values
        prev_valid = uv._prev_valid_idx(~torch.isnan(vals), uv._iota(vals))
        cand = prev_valid[:, self._locs(prev_locs)]
        base = torch.gather(vals, 1, cand.clamp(min=0))
        base = torch.where(cand < 0, vals.new_tensor(float("nan")), base)
        return self._with(values=vals[:, start:] - base, index=new_index)

    # -- lagging -------------------------------------------------------------

    def lags(self, max_lag: int, include_original: bool,
             lagged_key: Callable[[Any, int], Any] = lagged_pair_key
             ) -> "Panel":
        """Lagged panel: for each series the rows lag 0 (optional), lag 1
        .. lag ``max_lag``, dropping the first ``max_lag`` instants."""
        if not isinstance(self.index, UniformDateTimeIndex):
            raise ValueError("lags requires a UniformDateTimeIndex")
        n = self.n_obs
        start = 0 if include_original else 1
        new_vals = lag_stack(self.values, max_lag, include_original) \
            .reshape(-1, n - max_lag)
        new_keys = [lagged_key(k, lag)
                    for k in self.keys for lag in range(start, max_lag + 1)]
        return self._with(values=new_vals, keys=new_keys,
                          index=self.index.islice(max_lag, n))

    def lags_per_key(self, lags_per_key: dict,
                     lagged_key: Callable[[Any, int], Any] = lagged_pair_key
                     ) -> "Panel":
        """Per-key ``(include_original, max_lag)`` lagging."""
        if not isinstance(self.index, UniformDateTimeIndex):
            raise ValueError("lags requires a UniformDateTimeIndex")
        max_lag = max(ml for _, ml in lags_per_key.values())
        n = self.n_obs
        rows, new_keys = [], []
        for i, k in enumerate(self.keys):
            include, ml = lags_per_key[k]
            for lag in range(0 if include else 1, ml + 1):
                rows.append(self.values[i, max_lag - lag:n - lag])
                new_keys.append(lagged_key(k, lag))
        return self._with(values=torch.stack(rows), keys=new_keys,
                          index=self.index.islice(max_lag, n))

    # -- cross-series instant filters ----------------------------------------

    def _keep_instants(self, keep: torch.Tensor) -> "Panel":
        locs = np.flatnonzero(keep.cpu().numpy())
        nanos = self.index.to_nanos_array()[locs]
        return self._with(values=self.values[:, self._locs(locs)],
                          index=IrregularDateTimeIndex(nanos,
                                                       self.index.zone))

    def filter_by_instant(self, predicate: Callable[[torch.Tensor],
                                                    torch.Tensor],
                          filter_keys: Optional[Sequence[Any]] = None
                          ) -> "Panel":
        """Keep the instants where the elementwise ``predicate`` holds for
        at least one of the selected series; the result has an irregular
        index."""
        sub = self if filter_keys is None else self.select(filter_keys)
        return self._keep_instants(torch.any(predicate(sub.values), dim=0))

    def remove_instants_with_nans(self) -> "Panel":
        """Drop the instants where any series is NaN."""
        return self._keep_instants(
            ~torch.any(torch.isnan(self.values), dim=0))

    # -- resampling ----------------------------------------------------------

    def resample(self, target_index: DateTimeIndex, aggr: str = "mean",
                 closed_right: bool = False, stamp_right: bool = False
                 ) -> "Panel":
        """Window resampling onto ``target_index``."""
        vals = _resample_values(self.values, self.index, target_index, aggr,
                                closed_right, stamp_right)
        return self._with(values=vals, index=target_index)

    def with_index(self, new_index: DateTimeIndex,
                   default_value: float = np.nan) -> "Panel":
        """Rebase every series onto a new index, ``default_value`` at the
        instants the old one lacks.  The rebaser runs on the host: the
        values go there and come back to the panel's device."""
        with _metrics.span("panel.rebase"):
            rb = _rebaser(self.index, new_index, default_value)
            return self._with(values=torch.from_numpy(rb(self._host())),
                              index=new_index)

    # -- fits ----------------------------------------------------------------

    def fit_resilient(self, family: str, *args, engine=None, **kwargs):
        """Fail-soft batched fit of the panel on its device: per-series
        health masking, multi-start retry and the family's fallback chain
        (``"arima"``, args p, d, q; ``"ar"``, args max_lag; ``"ewma"``,
        ``"garch"``, ``"argarch"``, ``"egarch"``; ``"holt_winters"``, args
        period, model_type), so that one pathological series degrades its
        own lane's status instead of raising.  Extra args and kwargs (``retry=RetryPolicy(...)``,
        ``fallbacks=...``, arima's ``auto_order=True``) pass through to
        the family's ``fit_resilient``.  Returns ``(model, outcome)``.

        Routes through :meth:`FitEngine.fit_resilient
        <spark_timeseries_tpu_torch.engine.FitEngine.fit_resilient>`
        (``engine``, or a new engine): the series axis pads to its bucket
        with all-NaN lanes, which the chain skips, and the result is
        sliced to the real lanes; ``engine=False`` calls the family's
        chain directly."""
        from .engine import FitEngine
        with _metrics.span("panel.fit_resilient"):
            if engine is False:
                return FitEngine.resilient_dispatch(family)(
                    self.values, *args, device=self.device, **kwargs)
            eng = engine if engine is not None else FitEngine()
            return eng.fit_resilient(self.values, family, *args,
                                     device=self.device, **kwargs)

    def auto_fit(self, max_p: int = 5, max_d: int = 2, max_q: int = 5,
                 **kwargs):
        """Batched automatic ARIMA order selection over the whole panel on
        its device: :func:`~spark_timeseries_tpu_torch.models.arima.
        auto_fit_panel` (per-series d by batched KPSS, the (p, q)
        candidate grid, AIC argmin, a refine of each winner).  NaN-padded
        lanes fit their valid windows.  ``kwargs`` pass through
        (``max_iter``, ``screen_max_iter``, ``stats``).  Returns a
        :class:`~spark_timeseries_tpu_torch.models.arima.PanelARIMAFit`."""
        from .models import arima
        with _metrics.span("panel.auto_fit"):
            return arima.auto_fit_panel(self.values, max_p=max_p,
                                        max_d=max_d, max_q=max_q,
                                        device=self.device, **kwargs)

    def stream_fit(self, family: str = "arima", *, engine=None, **kwargs):
        """Stream this panel's series through
        :meth:`~spark_timeseries_tpu_torch.engine.FitEngine.stream_fit` on
        the panel's device, in chunks: ``chunk_size``, ``collect`` and the
        family's fit parameters pass through.  The engine stages chunks
        from the host, so a panel on a card is first copied to the host
        once, as the JAX engine does (``stats["input_d2h_s"]``).  Interior
        gaps must be filled first (:meth:`fill`).  ``engine`` an explicit
        :class:`~spark_timeseries_tpu_torch.engine.FitEngine`."""
        from .engine import FitEngine
        with _metrics.span("panel.stream_fit"):
            eng = engine if engine is not None else FitEngine()
            return eng.stream_fit(self.values, family, device=self.device,
                                  **kwargs)

    def backtest(self, grid=None, **kwargs):
        """Rolling-origin backtest: waits for ``backtest/``."""
        _waits_for("backtest", "6")

    def describe_costs(self, family: str = "arima") -> dict:
        """The JAX package's XLA cost report: waits for the port's
        launch-count and byte tooling."""
        _waits_for("describe_costs", "8")

    # -- summary stats -------------------------------------------------------

    def series_stats(self) -> dict:
        """Per-series count / mean / stdev / min / max, NaN-aware, as a
        dict of ``(n_series,)`` numpy arrays."""
        v = self.values
        m = ~torch.isnan(v)
        zero = v.new_tensor(0.0)
        cnt = m.sum(dim=1)
        safe_cnt = cnt.clamp(min=1)
        mean = torch.where(m, v, zero).sum(dim=1) / safe_cnt
        var = torch.where(m, (v - mean[:, None]) ** 2, zero).sum(dim=1) \
            / (safe_cnt - 1).clamp(min=1)
        inf = v.new_tensor(float("inf"))
        return {
            "count": cnt.cpu().numpy(),
            "mean": mean.cpu().numpy(),
            "stdev": torch.sqrt(var).cpu().numpy(),
            "min": torch.where(m, v, inf).min(dim=1).values.cpu().numpy(),
            "max": torch.where(m, v, -inf).max(dim=1).values.cpu().numpy(),
        }

    # -- instants / pandas bridges -------------------------------------------

    def to_instants(self) -> List[Tuple[Any, np.ndarray]]:
        """List of ``(datetime, cross-section vector)`` pairs."""
        tm = self._host().T
        return [(self.index.datetime_at_loc(i), tm[i])
                for i in range(self.n_obs)]

    def to_instants_dataframe(self):
        """Wide DataFrame: one row per instant, one column per key."""
        import pandas as pd
        df = pd.DataFrame(self._host().T,
                          columns=[str(k) for k in self.keys])
        df.insert(0, "instant", self.index.to_datetime_array())
        return df

    def to_observations_dataframe(self, ts_col: str = "timestamp",
                                  key_col: str = "key",
                                  value_col: str = "value"):
        """Long DataFrame of ``(timestamp, key, value)`` observations,
        NaNs dropped."""
        import pandas as pd
        host = self._host()
        dts = np.array(self.index.to_datetime_array(), dtype=object)
        mask = ~np.isnan(host)
        s_idx, t_idx = np.nonzero(mask)
        return pd.DataFrame({
            ts_col: dts[t_idx],
            key_col: np.array([str(k) for k in self.keys],
                              dtype=object)[s_idx],
            value_col: host[mask],
        })

    def to_pandas(self):
        """Wide DataFrame indexed by datetime, the keys as columns."""
        import pandas as pd
        return pd.DataFrame(
            self._host().T,
            index=pd.DatetimeIndex(self.index.to_datetime_array()),
            columns=[str(k) for k in self.keys])

    def collect(self) -> Tuple[List[Any], np.ndarray]:
        """``(keys, values)`` on the host."""
        with _metrics.span("panel.collect"):
            host = self._host()
        _metrics.inc("panel.d2h_bytes", int(host.nbytes))
        return self.keys, host

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_series(pairs: Iterable[Tuple[Any, DateTimeIndex, np.ndarray]],
                    target_index: DateTimeIndex, device=None) -> "Panel":
        """Build from ``(key, index, values)`` triples, each rebased onto
        ``target_index`` (float64 on the host)."""
        with _metrics.span("panel.from_series"):
            keys, rows = [], []
            for key, idx, vals in pairs:
                rb = _rebaser(idx, target_index, np.nan)
                keys.append(key)
                rows.append(rb(np.asarray(vals, dtype=np.float64)))
            _metrics.inc("panel.ingested_series", len(keys))
            return Panel(target_index, np.stack(rows), keys, device=device)

    @staticmethod
    def from_observations(df, target_index: DateTimeIndex,
                          ts_col: str = "timestamp", key_col: str = "key",
                          value_col: str = "value", device=None) -> "Panel":
        """Long observations DataFrame -> panel: factorize the keys,
        resolve every timestamp's location at once, one scatter into the
        dense float64 panel on the host."""
        with _metrics.span("panel.from_observations"):
            keys_arr = np.asarray(df[key_col])
            uniq_keys, key_codes = np.unique(keys_arr, return_inverse=True)
            locs = target_index.locs_at(_timestamps_to_nanos(df[ts_col]))
            vals = np.asarray(df[value_col], dtype=np.float64)
            data = np.full((len(uniq_keys), len(target_index)), np.nan)
            ok = locs >= 0
            data[key_codes[ok], locs[ok]] = vals[ok]
            _metrics.inc("panel.ingested_observations", int(len(vals)))
            _metrics.inc("panel.ingested_series", int(len(uniq_keys)))
            return Panel(target_index, data, list(uniq_keys), device=device)

    @staticmethod
    def from_pandas(df, target_index: Optional[DateTimeIndex] = None,
                    device=None) -> "Panel":
        """Wide DataFrame (datetime index, one column per key) -> panel."""
        if target_index is None:
            target_index = IrregularDateTimeIndex(
                _timestamps_to_nanos(df.index))
        return Panel(target_index, df.to_numpy(dtype=np.float64).T,
                     list(df.columns), device=device)


def panel_from_numpy(index_string: str, values, keys: Sequence[Any],
                     device=None) -> Panel:
    """A panel from another package's parts: its index's ``to_string()``
    form, its values as an array and its keys (for example a JAX-package
    panel's ``index.to_string()``, ``np.asarray(values)`` and ``keys``)."""
    from .time import from_string
    return Panel(from_string(index_string), values, keys, device=device)


def _timestamps_to_nanos(ts) -> np.ndarray:
    """Datetime-likes -> epoch nanos, int64."""
    import pandas as pd
    dtindex = pd.DatetimeIndex(ts)
    if dtindex.tz is not None:
        dtindex = dtindex.tz_convert("UTC").tz_localize(None)
    return dtindex.as_unit("ns").asi8.astype(np.int64)
