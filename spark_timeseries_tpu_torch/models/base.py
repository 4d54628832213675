"""Model-tier base types (counterpart of
``spark_timeseries_tpu/models/base.py``).  Models are NamedTuples of
tensors whose parameter fields may carry a leading ``(n_series,)`` dim:
one model object is a whole panel's fit.  :func:`refit_unconverged`
refits a batched fit's unconverged lanes, gathered."""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..utils.resilience import _lane_leaf, _tree_map


def normal_quantile(conf, dtype=torch.float64) -> torch.Tensor:
    """Two-sided standard-normal quantile: ``z`` with ``P(|Z| < z) =
    conf`` (1.95996 at 0.95)."""
    return math.sqrt(2.0) * torch.erfinv(torch.as_tensor(conf, dtype=dtype))


class FitDiagnostics(NamedTuple):
    """Per-lane optimizer outcome attached to every fitted model.

    ``converged`` is False for lanes whose optimizer hit its iteration cap
    and for lanes quarantined back to their initial guess; ``fun`` is the
    objective at the returned parameters.  ``attempts`` is the per-lane
    multi-start solve count of a fit with a retry policy
    (``utils.resilience.RetryPolicy``), else None."""
    converged: torch.Tensor   # bool (...,)
    n_iter: torch.Tensor      # (...,)
    fun: torch.Tensor         # (...,)
    attempts: Optional[torch.Tensor] = None   # (...,) multi-start solves


def diagnostics_from(res, lane_ok=None) -> FitDiagnostics:
    """:class:`FitDiagnostics` from a ``MinimizeResult``; ``lane_ok`` (True
    = kept the optimizer's result) demotes quarantined lanes, and a lane
    with a non-finite objective is never converged."""
    converged = res.converged
    if lane_ok is not None:
        converged = converged & lane_ok.reshape(converged.shape)
    return FitDiagnostics(converged & torch.isfinite(res.fun), res.n_iter,
                          res.fun, getattr(res, "attempts", None))


def refit_unconverged(values, model, fit_fn, min_bucket: int = 256):
    """Gather the lanes of a batched fit that did not converge, refit
    them, and scatter the results back (the JAX package's
    ``refit_unconverged``): cost scales with the unconverged share, not
    the panel.

    ``values (n_series, n)`` is the data the model was fitted on;
    ``model`` any fitted model NamedTuple whose ``diagnostics.converged``
    has one entry per series.  ``fit_fn(sub_values, sub_model) ->
    sub_fitted`` refits the gathered lanes, given their slice of the
    model so that it can warm-start, e.g.::

        model = refit_unconverged(
            values, model,
            lambda v, m: arima.fit(2, 1, 2, v, max_iter=500,
                                   user_init_params=m.coefficients))

    The gathered batch is padded (repeating the first hard lane) up to a
    power of two ``>= min_bucket``, never past the panel's size.  Lanes
    already converged come back as they were."""
    if getattr(model, "diagnostics", None) is None:
        raise ValueError("model carries no diagnostics; fit it first")
    conv = model.diagnostics.converged
    conv = conv.detach().cpu().numpy() if isinstance(conv, torch.Tensor) \
        else np.asarray(conv)
    if conv.ndim == 0:
        raise ValueError(
            "model is unbatched (scalar diagnostics); refit_unconverged "
            "needs a batched fit — re-fit the single series directly")
    conv = conv.reshape(-1)
    n_series = conv.shape[0]
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    if values.ndim < 2 or values.shape[0] != n_series:
        raise ValueError(
            f"values {tuple(values.shape)} does not match the model's "
            f"{n_series} diagnosed lanes")
    idx = np.flatnonzero(~conv)
    if idx.size == 0:
        return model
    bucket = max(min_bucket, 1 << (int(idx.size) - 1).bit_length())
    bucket = min(bucket, n_series)
    pad_idx = idx if bucket == idx.size else np.concatenate(
        [idx, np.full(bucket - idx.size, idx[0], idx.dtype)])

    def lanes(a, device):
        return torch.as_tensor(a, device=device)

    sub_model = _tree_map(
        lambda leaf: leaf.index_select(0, lanes(pad_idx, leaf.device))
        if _lane_leaf(leaf, n_series) else leaf, model)
    sub_fitted = fit_fn(values.index_select(0, lanes(pad_idx, values.device)),
                        sub_model)
    k = idx.size

    def merge(orig, new):
        if not _lane_leaf(orig, n_series):
            return orig
        out = orig.clone()
        out[lanes(idx, orig.device)] = new[:k].to(device=orig.device,
                                                  dtype=orig.dtype)
        return out

    return _tree_map(merge, model, sub_fitted)


class TimeSeriesModel:
    """Informal interface; concrete models are NamedTuples."""

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """Strip this model's time-dependent structure (the inverse of
        :meth:`add_time_dependent_effects`)."""
        raise NotImplementedError

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Overlay this model's time-dependent structure on i.i.d.
        draws."""
        raise NotImplementedError


def scalar_or_batch(x: Any) -> torch.Tensor:
    """A parameter as a tensor (scalar or ``(batch,)``)."""
    return torch.as_tensor(x)
