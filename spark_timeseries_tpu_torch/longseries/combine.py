"""The DARIMA combiner: segment estimates → one global model, by WLS
(counterpart of ``spark_timeseries_tpu/longseries/combine.py``).

Per-segment ARMA estimates live in incompatible parameter spaces the
moment segments choose different orders (the ``auto`` path), and even
at a common order, averaging raw ``(φ, θ)`` ignores how unequally
segments determine them.  DARIMA's answer (arXiv 2007.09577; the DLSA
scheme) in two moves:

1. **Common space**: every segment's ``(c, φ, θ)`` maps to its
   truncated AR(∞) representation ``(c_π, π₁..π_{n_ar})``
   (:func:`~spark_timeseries_tpu_torch.models.arima.ar_truncation`), so
   heterogeneous segment orders become coordinates of one linear model
   ``y_t = c_π + Σ π_j y_{t-j} + e_t``.
2. **Inverse-covariance weights**: in that linear model a segment
   estimator's precision is its design information ``X_kᵀX_k / σ̂²_k``
   (``X_k`` the segment's lag design, ``σ̂²_k`` its AR-residual
   variance), so the weighted-least-squares combination

       θ* = (Σ_k X_kᵀX_k/σ̂²_k)⁻¹ Σ_k (X_kᵀX_k/σ̂²_k) θ_k

   is one tiny SPD solve after a sum of per-segment gram products.

Each chunk of segments is one call of :func:`_combine_chunk_impl` on the
device; its sums are added in place into device accumulators, so the
host crosses once per combination: one copy of the packed 7-tuple of
sums (:func:`_acc_to_host`, exactly :func:`expected_combine_acc_bytes`
bytes) before the ridge-guarded float64 solve.  The gram products are
``torch.einsum`` (batched matrix products), as the JAX package computes
them outside any Pallas kernel.  :func:`fused_fit_combine` also fits
each chunk's segments (``models.arima.segment_fit_outputs``: on the card
one ``arma_lm_fit`` launch a chunk) and folds them in before the next
chunk, so the per-segment coefficients never reach the host.  Segments
with non-finite estimates, grams or variances get weight zero; if
nothing is weightable the result falls back to the plain mean of finite
segment estimates.

Overlapping windows (``split.segment_panel`` with ``overlap > 0``)
double-cover ``overlap`` observations per boundary; the ``burn``
(``max(n_ar, overlap)``) zero-weights each window's leading rows so
every observation contributes to exactly one segment's gram.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import check_dtype, resolve_device
from ..utils import metrics as _metrics

__all__ = ["combine_segments", "fused_fit_combine",
           "expected_combine_acc_bytes", "CombinedResult"]


def expected_combine_acc_bytes(n_ar: int, include_intercept: bool = True,
                               dtype=np.float32) -> int:
    """Bytes of the one device→host crossing of a combination: the
    accumulators ``A (D,D)``, ``b (D,)``, ``theta_sum (D,)`` and
    ``sig_sum`` in the panel dtype, and three int32 counters.  What
    ``longseries.fused_bytes_d2h`` counts per fused combination."""
    D = (1 if include_intercept else 0) + int(n_ar)
    it = np.dtype(dtype).itemsize
    return (D * D + 2 * D + 1) * it + 3 * 4


class CombinedResult(NamedTuple):
    """Outcome of one WLS combination.

    ``coefficients (D,)`` in the fit layout ``[c_π?, π₁..π_{n_ar}]``
    (host numpy, the panel dtype); ``sigma2`` the ok-segment mean
    AR-residual variance; ``used_wls`` False when no segment was
    weightable and the mean-of-finite fallback produced the
    coefficients."""
    coefficients: np.ndarray
    sigma2: float
    n_segments: int
    n_finite: int
    n_weighted: int
    n_converged: int
    used_wls: bool


def _combine_chunk_impl(segs: torch.Tensor, coefs: torch.Tensor,
                        conv: torch.Tensor, p: int, q: int, icpt: int,
                        n_ar: int, burn: int):
    """One chunk of segments → its summed combination pieces.

    ``segs (K, L)`` segment windows, ``coefs (K, icpt+p+q)`` per-segment
    ARMA estimates (NaN rows = failed segments), ``conv (K,)`` their
    converged flags, all on one device.  Returns the chunk's sums
    ``(A (D,D), b (D,), n_ok, theta_sum (D,), n_finite, sigma2_sum,
    n_conv)``, with no host sync."""
    from ..models.arima import _split_params, ar_truncation
    from ..ops.lag import lag_stack

    dtype = segs.dtype
    K, L = segs.shape
    D = icpt + n_ar
    c, phi, theta = _split_params(coefs, p, q, icpt)
    c_pi, pi = ar_truncation(c, phi, theta, n_ar)            # (K,), (K,n_ar)
    th = torch.cat([c_pi[:, None], pi], dim=-1) if icpt else pi  # (K, D)

    X = lag_stack(segs, n_ar)                                # (K, n_ar, R)
    rows = L - n_ar
    if icpt:
        X = torch.cat([segs.new_ones((K, 1, rows)), X], dim=-2)
    y_t = segs[..., n_ar:]
    # row r targets window index n_ar + r; burn rows carry weight 0 (the
    # 0/1 weights square to themselves, so weighting one gram side is
    # exact)
    w = ((n_ar + torch.arange(rows, device=segs.device)) >= burn).to(dtype)
    Xw = X * w
    G = torch.einsum("kpn,kqn->kpq", Xw, X)                  # (K, D, D)
    resid = (y_t - torch.einsum("kpn,kp->kn", X, th)) * w
    n_live = float(max(rows - max(burn - n_ar, 0), 0))
    dof = max(n_live - D, 1.0)
    sigma2 = (resid * resid).sum(dim=-1) / dof               # (K,)

    finite = torch.isfinite(th).all(dim=-1)
    ok = finite & torch.isfinite(sigma2) & (sigma2 > 0) \
        & torch.isfinite(G).all(dim=-1).all(dim=-1)
    zero = torch.zeros((), dtype=dtype, device=segs.device)
    # zero unusable segments with where (NaN·0 is NaN: a poisoned
    # segment must not leak through the sums)
    Wk = torch.where(ok[:, None, None],
                     G / torch.where(ok, sigma2, torch.ones_like(sigma2))
                     [:, None, None], zero)
    th_ok = torch.where(ok[:, None], th, zero)
    A = Wk.sum(dim=0)
    b = torch.einsum("kpq,kq->kp", Wk, th_ok).sum(dim=0)
    theta_sum = torch.where(finite[:, None], th, zero).sum(dim=0)
    sig_sum = torch.where(ok, sigma2, zero).sum()
    n_conv = (ok & conv.to(torch.bool)).sum()
    return (A, b, ok.sum(), theta_sum, finite.sum(), sig_sum, n_conv)


def _zero_acc(D: int, dtype: torch.dtype, device: torch.device):
    """Fresh device accumulators in the combine layout ``(A, b, n_ok,
    theta_sum, n_finite, sig_sum, n_conv)``: float pieces in the panel
    dtype, counters int32."""
    i32 = torch.int32
    return (torch.zeros((D, D), dtype=dtype, device=device),
            torch.zeros((D,), dtype=dtype, device=device),
            torch.zeros((), dtype=i32, device=device),
            torch.zeros((D,), dtype=dtype, device=device),
            torch.zeros((), dtype=i32, device=device),
            torch.zeros((), dtype=dtype, device=device),
            torch.zeros((), dtype=i32, device=device))


def _fold(acc, out) -> None:
    """Add one chunk's sums into the accumulators, in place."""
    for a, o in zip(acc, out):
        a.add_(o.to(a.dtype))


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def _acc_to_host(acc):
    """The one device→host crossing: the 7 accumulators packed as bytes
    on the device, copied in one transfer, unpacked on the host.
    Returns ``(numpy 7-tuple, bytes copied)``."""
    flat = torch.cat([a.reshape(-1).contiguous().view(torch.uint8)
                      for a in acc])
    raw = flat.cpu().numpy()
    out, off = [], 0
    for a in acc:
        nb = a.numel() * a.element_size()
        out.append(np.frombuffer(raw[off:off + nb].tobytes(),
                                 _host_dtype(a.dtype))
                   .reshape(tuple(a.shape)))
        off += nb
    return tuple(out), int(raw.nbytes)


def _finalize(acc_host, *, D: int, K: int, dtype,
              ridge: float) -> CombinedResult:
    """Shared tail of both combine paths: ``acc_host`` is the 7-tuple of
    numpy accumulators, so this is host arithmetic: the ridge-guarded
    float64 WLS solve, the mean-of-finite fallback and the counters."""
    A = np.asarray(acc_host[0], np.float64)
    b = np.asarray(acc_host[1], np.float64)
    n_ok = int(acc_host[2])
    theta_sum = np.asarray(acc_host[3], np.float64)
    n_finite = int(acc_host[4])
    sig_sum = float(acc_host[5])
    n_conv = int(acc_host[6])

    used_wls = False
    combined = np.zeros((D,), np.float64)
    if n_ok:
        scale = max(float(np.max(np.abs(np.diag(A)))), 1.0)
        solved = np.linalg.solve(A + ridge * scale * np.eye(D), b)
        if np.all(np.isfinite(solved)):
            combined = solved
            used_wls = True
    if not used_wls and n_finite:
        combined = theta_sum / n_finite
    sigma2 = sig_sum / n_ok if n_ok else float("nan")
    reg = _metrics.get_registry()
    reg.inc("longseries.segments_combined", n_ok)
    reg.inc("longseries.segments_dropped", K - n_ok)
    return CombinedResult(
        coefficients=combined.astype(dtype),
        sigma2=sigma2, n_segments=K, n_finite=n_finite,
        n_weighted=n_ok, n_converged=n_conv, used_wls=used_wls)


def _check_window(L: int, n_ar: int, overlap: int, icpt: int) -> None:
    if L <= max(n_ar, overlap) + n_ar + icpt:
        raise ValueError(
            f"segment window {L} too short for an AR({n_ar}) design "
            f"with burn-in {max(n_ar, overlap)}")


def combine_segments(segs, coefs, converged=None, *,
                     p: int, q: int, include_intercept: bool = True,
                     n_ar: int, overlap: int = 0,
                     chunk_segments: int = 256,
                     ridge: float = 1e-8, device=None) -> CombinedResult:
    """Combine per-segment ARMA estimates into one global AR(``n_ar``)
    model by design-gram WLS (module docstring has the algebra).

    ``segs (K, L)`` the segment panel (``split.segment_panel``; array or
    tensor), ``coefs (K, icpt+p+q)`` per-segment estimates in the fit
    layout (NaN rows = dead segments, weight 0), ``converged (K,)``
    optional convergence flags (reporting only).  Runs on ``device``
    (``None`` means CUDA); chunks of ``chunk_segments`` segments are
    moved there one after another and summed into device accumulators,
    which cross to the host once (:func:`_acc_to_host`)."""
    dev = resolve_device(device)
    segs_t = segs if isinstance(segs, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(segs))
    check_dtype(segs_t.dtype, dev)
    dtype = segs_t.dtype
    coefs_t = torch.as_tensor(coefs).to(dtype)
    K, L = segs_t.shape
    if coefs_t.shape[0] != K:
        raise ValueError(
            f"{coefs_t.shape[0]} coefficient rows for {K} segments")
    icpt = 1 if include_intercept else 0
    n_ar = int(n_ar)
    _check_window(L, n_ar, overlap, icpt)
    conv = torch.ones((K,), dtype=torch.bool) if converged is None \
        else torch.as_tensor(converged).to(torch.bool).reshape(K)
    burn = max(n_ar, int(overlap))
    D = icpt + n_ar

    step = max(1, int(chunk_segments))
    acc = _zero_acc(D, dtype, dev)
    with _metrics.span("longseries.combine"):
        for s in range(0, K, step):
            out = _combine_chunk_impl(
                segs_t[s:s + step].to(dev), coefs_t[s:s + step].to(dev),
                conv[s:s + step].to(dev), int(p), int(q), icpt, n_ar, burn)
            _fold(acc, out)
        acc_host, _ = _acc_to_host(acc)
    return _finalize(acc_host, D=D, K=K, dtype=_host_dtype(dtype),
                     ridge=ridge)


def fused_fit_combine(panel, *, p: int, q: int,
                      include_intercept: bool = True, n_ar: int,
                      overlap: int = 0, chunk_segments: int = 256,
                      ridge: float = 1e-8, method: str = "css-lm",
                      max_iter: Optional[int] = None,
                      objective: str = "css", device=None,
                      stats: Optional[dict] = None) -> CombinedResult:
    """The fused ``fit_long`` path: each chunk of segments is fitted
    (``models.arima.segment_fit_outputs``: on the card one ``arma_lm_fit``
    launch) and its WLS pieces folded into the device accumulators before
    the next chunk; the per-segment coefficients never reach the host,
    which sees one copy of the 7-tuple of sums.

    Only a chunk's real segments are fitted: the JAX package pads the
    last chunk with zero lanes to compile one executable and masks them
    in its program, and the port, which compiles nothing, leaves them
    out (a lane's fit does not depend on its batch, so the real lanes'
    results are the same).  The chunks are the staged path's
    (``engine.stream_fit`` at ``chunk_size=chunk_segments``), so a
    segment's coefficients are the staged path's, bit for bit.

    Counters: ``longseries.fused_programs`` (chunks) and
    ``longseries.fused_bytes_d2h`` (bytes of the one copy to the host,
    :func:`expected_combine_acc_bytes`).  ``stats`` (a dict) receives
    ``lm_fit_launches`` (the chunks' LM-fit launches; 0 on the CPU) and
    ``n_chunks``."""
    from ..models.arima import segment_fit_outputs

    dev = resolve_device(device)
    panel_t = panel if isinstance(panel, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(panel))
    check_dtype(panel_t.dtype, dev)
    K, L = panel_t.shape
    icpt = 1 if include_intercept else 0
    n_ar = int(n_ar)
    _check_window(L, n_ar, overlap, icpt)
    burn = max(n_ar, int(overlap))
    D = icpt + n_ar
    step = max(1, min(int(chunk_segments), K))
    mi = None if max_iter is None else int(max_iter)

    acc = _zero_acc(D, panel_t.dtype, dev)
    programs = 0
    launches = 0
    with _metrics.span("longseries.fused_fit_combine"):
        for s in range(0, K, step):
            part = panel_t[s:s + step].to(dev)
            st: dict = {}
            coefs, conv = segment_fit_outputs(
                p, q, part, include_intercept=icpt != 0, method=method,
                max_iter=mi, objective=objective, device=dev, stats=st)
            launches += int(st.get("lm_fit_launches", 0))
            _fold(acc, _combine_chunk_impl(part, coefs, conv, int(p), int(q),
                                           icpt, n_ar, burn))
            programs += 1
        acc_host, nbytes = _acc_to_host(acc)
    reg = _metrics.get_registry()
    reg.inc("longseries.fused_programs", programs)
    reg.inc("longseries.fused_bytes_d2h", nbytes)
    if stats is not None:
        stats["lm_fit_launches"] = launches
        stats["n_chunks"] = programs
    return _finalize(acc_host, D=D, K=K, dtype=_host_dtype(panel_t.dtype),
                     ridge=ridge)
