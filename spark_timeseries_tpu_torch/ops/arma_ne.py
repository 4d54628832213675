"""Fused ARMA normal equations and the CSS Levenberg-Marquardt fit around
them (counterpart of ``spark_timeseries_tpu/ops/pallas_arma.py``).

Every Levenberg-Marquardt iteration of the ARIMA CSS fit needs, per lane,
``(JᵀJ, Jᵀr, sse)`` of the one-step residuals.  Three entry points run
that pass, each a hand-written kernel of ``csrc/arma_ne.cu`` on a CUDA
tensor and a plain PyTorch version on a CPU tensor, with no fallback
between the two (a kernel that fails to build or launch raises):

- :func:`normal_equations`, one pass (``arma_ne_kernel``, the port of the
  Pallas kernel ``spark_timeseries_tpu/ops/pallas_arma.py::_ne_kernel``;
  plain: :func:`normal_equations_plain`, the same arithmetic written as a
  Python loop over time steps on the lane batch);
- :func:`fit_css_lm`, the whole LM fit of a panel, or of a candidate
  grid ``x0 (C·S, k)`` over one ``(S, n)`` panel (``arma_lm_fit_kernel``:
  one launch that runs every lane's solver state machine on the card, or,
  given each candidate's order in ``grid_orders``, one launch per
  candidate at that order; plain: :func:`fit_css_lm_plain`, the batched
  LM loop over the plain pass).  :func:`fit_css_lm_route` runs the same batched loop over
  :func:`normal_equations`, one kernel launch per iteration: the route the
  LM-fit kernel is held against.  The ARIMA fit runs :func:`fit_css_lm`;
- :func:`css_cost`, the CSS cost alone (``arma_css_kernel``; plain:
  :func:`css_cost_plain`).

The kernels take the panel time-major (``(n_obs, S)``, so a warp's loads
at one step are contiguous); the fits transpose the panel once, as the
Pallas solver blocks it once up front.  The normal-equations and LM-fit
kernels are instantiated for ``p, q <= 5`` with and without intercept
(``csrc/arma_ne.cuh``, spread over ``csrc/arma_ne.orders*.cu``).  What
bounds the kernels on the H100 is written in the source note of
``csrc/arma_ne.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import _build
from .optimize import lm_state_machine

KERNEL_MAX_ORDER = 5      # p, q <= 5, with and without intercept, are
                          # instantiated (csrc/arma_ne.orders*.cu)


def _triu_pairs(k: int):
    return [(a, b) for a in range(k) for b in range(a, k)]


def n_outputs(k: int) -> int:
    """Rows of the packed output ``[sse, triu(JᵀJ)..., Jᵀr...]``."""
    return 1 + k * (k + 1) // 2 + k


def check_kernel_order(p: int, q: int, icpt: int) -> None:
    """Raise unless the CUDA kernels (the normal equations and the LM
    fit) have an instantiation for the order: every ``p, q <=``
    :data:`KERNEL_MAX_ORDER`, with and without intercept."""
    if not (0 <= p <= KERNEL_MAX_ORDER and 0 <= q <= KERNEL_MAX_ORDER):
        raise ValueError(
            f"the CUDA ARMA kernels take p, q <= {KERNEL_MAX_ORDER} (with "
            f"or without intercept), got ARMA({p},{q}); larger orders are "
            f"not instantiated")
    if icpt + p + q == 0:
        raise ValueError("the ARMA kernel needs at least one parameter")


def _check_window(n_obs: int, p: int, q: int) -> None:
    if n_obs <= max(p, q):
        raise ValueError(
            f"series too short for the CSS window: need more than "
            f"max(p, q) = {max(p, q)} observations, got {n_obs}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.library("arma_ne").arma_ne_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(params_t: torch.Tensor, y_t: torch.Tensor,
            nv: Optional[torch.Tensor], p: int, q: int,
            icpt: int) -> torch.Tensor:
    """Launch ``csrc/arma_ne.cu`` on the current stream; returns the packed
    ``(n_out, S)`` output (not synchronised)."""
    check_kernel_order(p, q, icpt)
    k = icpt + p + q
    n_obs, S = y_t.shape
    _build.check_inputs([y_t, params_t] + ([] if nv is None else [nv]),
                        "ARMA")
    if params_t.shape != (k, S) or (nv is not None and nv.shape != (S,)):
        raise ValueError(
            f"shape mismatch: params {tuple(params_t.shape)} (expected "
            f"{(k, S)}), y {tuple(y_t.shape)}, n_valid "
            f"{None if nv is None else tuple(nv.shape)}")
    _check_window(n_obs, p, q)
    out = torch.empty((n_outputs(k), S), dtype=torch.float32,
                      device=y_t.device)
    _build.launch(_kernel_fn(), y_t.device, params_t.data_ptr(),
                  y_t.data_ptr(), 0 if nv is None else nv.data_ptr(),
                  out.data_ptr(), S, n_obs, p, q, icpt,
                  what=f"arma_ne kernel launch failed for ARMA({p},{q}) "
                       f"icpt={icpt} S={S} n_obs={n_obs}")
    normal_equations.launches += 1
    return out


def _packed_plain(params_t: torch.Tensor, y_t: torch.Tensor,
                  nv: Optional[torch.Tensor], p: int, q: int,
                  icpt: int, grad: bool = True) -> torch.Tensor:
    """The kernel's arithmetic as plain tensor ops over the lane batch,
    step by step in the kernel's order; any float dtype and device.
    ``grad=False`` is the cost-only kernel's: ``(1, S)`` sse, no tangents."""
    k = icpt + p + q
    n_obs = y_t.shape[0]
    ml = max(p, q)
    _check_window(n_obs, p, q)
    pairs = _triu_pairs(k)
    zero = torch.zeros_like(y_t[0])
    one = torch.ones_like(y_t[0])
    c = params_t[0] if icpt else zero
    phi = [params_t[icpt + j] for j in range(p)]
    theta = [params_t[icpt + p + m] for m in range(q)]
    e_ring = [zero] * q
    T_ring = [[zero] * k for _ in range(q)]
    sse = zero
    jtj = [zero] * len(pairs)
    jtr = [zero] * k
    for t in range(ml, n_obs):
        y_lags = [y_t[t - j - 1] for j in range(p)]
        yhat = c
        for j in range(p):
            yhat = yhat + phi[j] * y_lags[j]
        for m in range(q):
            yhat = yhat + theta[m] * e_ring[m]
        e = y_t[t] - yhat
        if not grad:
            if nv is not None:
                e = e * (t < nv).to(y_t.dtype)
            sse = sse + e * e
            if q:
                e_ring = [e] + e_ring[:-1]
            continue
        T = []
        for x in range(k):
            if x < icpt:
                u = one
            elif x < icpt + p:
                u = y_lags[x - icpt]
            else:
                u = e_ring[x - icpt - p]
            s = u
            for m in range(q):
                s = s + theta[m] * T_ring[m][x]
            T.append(-s)
        if nv is not None:
            w = (t < nv).to(y_t.dtype)
            e = e * w
            T = [tx * w for tx in T]
        sse = sse + e * e
        jtj = [jtj[i] + T[a] * T[b] for i, (a, b) in enumerate(pairs)]
        jtr = [jtr[x] + T[x] * e for x in range(k)]
        if q:
            e_ring = [e] + e_ring[:-1]
            T_ring = [T] + T_ring[:-1]
    if not grad:
        return sse[None]
    return torch.stack([sse, *jtj, *jtr])


def _packed(params_t, y_t, nv, p, q, icpt) -> torch.Tensor:
    """Device dispatch: the kernel for CUDA tensors, the plain loop for
    CPU tensors."""
    if y_t.is_cuda:
        return _launch(params_t, y_t, nv, p, q, icpt)
    return _packed_plain(params_t, y_t, nv, p, q, icpt)


@functools.lru_cache(maxsize=None)
def _triu_index(k: int, device: torch.device):
    """Row and column indices of the packed upper triangle, made once per
    order and device (a fresh host-to-device copy per LM iteration would
    stall the loop)."""
    pairs = _triu_pairs(k)
    return (torch.tensor([a for a, _ in pairs], device=device),
            torch.tensor([b for _, b in pairs], device=device))


def _unpack(out: torch.Tensor, k: int):
    """``(n_out, S)`` packed output -> ``(JᵀJ (S,k,k), Jᵀr (S,k),
    sse (S,))``."""
    n_tri = k * (k + 1) // 2
    S = out.shape[1]
    tri = out[1:1 + n_tri].T
    rows, cols = _triu_index(k, out.device)
    jtj = out.new_zeros((S, k, k))
    jtj[:, rows, cols] = tri
    jtj[:, cols, rows] = tri
    return jtj, out[1 + n_tri:].T, out[0]


def _masked_ne(jtj, jtr, sse, mask):
    """Chain-rule factor of the masked objective ``r(x ∘ mask)``: the
    recurrence runs at the masked point, the outputs are post-scaled."""
    return (jtj * mask[:, :, None] * mask[:, None, :], jtr * mask, sse)


def _normal_equations(packed_fn, params, y, p, q, icpt, mask, n_valid):
    k = icpt + p + q
    _check_window(y.shape[-1], p, q)
    if mask is not None:
        mask = mask.to(params.dtype)
        params = params * mask
    nv = None if n_valid is None else n_valid.to(y.dtype).contiguous()
    out = packed_fn(params.T.contiguous(), y.T.contiguous(), nv, p, q, icpt)
    res = _unpack(out, k)
    return _masked_ne(*res, mask) if mask is not None else res


def normal_equations(params: torch.Tensor, y: torch.Tensor,
                     p: int, q: int, icpt: int,
                     mask: Optional[torch.Tensor] = None,
                     n_valid: Optional[torch.Tensor] = None):
    """Batched fused ``(JᵀJ (S, k, k), Jᵀr (S, k), sse (S,))`` of the ARMA
    CSS residuals; ``params (S, k)``, ``y (S, n)``.

    A CUDA tensor launches the kernel (float32, ``p, q <= 5``; anything
    else raises) and adds one to ``normal_equations.launches``; a CPU
    tensor runs :func:`normal_equations_plain`.  ``mask (S, k)`` gives the
    masked objective ``r(x ∘ mask)``; ``n_valid (S,)`` restricts each lane
    to its left-aligned valid window (``ops.ragged``)."""
    return _normal_equations(_packed, params, y, p, q, icpt, mask, n_valid)


normal_equations.launches = 0


def normal_equations_plain(params: torch.Tensor, y: torch.Tensor,
                           p: int, q: int, icpt: int,
                           mask: Optional[torch.Tensor] = None,
                           n_valid: Optional[torch.Tensor] = None):
    """:func:`normal_equations` as plain tensor ops, on any device and
    float dtype — the version the kernel is held against."""
    return _normal_equations(_packed_plain, params, y, p, q, icpt, mask,
                             n_valid)


def _css_neg_ll(ne_fn, params, y, p, q, icpt, n_valid):
    _, jtr, css = ne_fn(params, y, p, q, icpt, n_valid=n_valid)
    n_eff = float(y.shape[-1]) if n_valid is None else n_valid.to(y.dtype)
    sigma2 = css / n_eff
    # the JAX package's _log_likelihood_css_arma, negated
    neg_ll = -((-n_eff / 2.0) * torch.log(2.0 * math.pi * sigma2)
               - css / (2.0 * sigma2))
    return neg_ll, (n_eff / css)[:, None] * jtr


def css_neg_ll_value_and_grad(params: torch.Tensor, y: torch.Tensor, p: int,
                              q: int, icpt: int,
                              n_valid: Optional[torch.Tensor] = None):
    """The negative CSS log likelihood of ARMA(p, q) lanes and its
    gradient from one :func:`normal_equations` pass: ``(neg_ll (S,),
    grad (S, k))`` for ``params (S, k)``, ``y (S, n)``.

    With ``css = Σ r²`` over ``t >= max(p, q)`` and ``σ² = css / n`` (``n``
    the window: the series length, or ``n_valid``), ``-LL = (n / 2)
    log(2π σ²) + css / (2σ²)`` and ``∇(-LL) = (n / css) · Jᵀr``, ``J`` the
    residuals' Jacobian.  On CUDA one ``arma_ne`` kernel launch; on the
    CPU the plain pass."""
    return _css_neg_ll(normal_equations, params, y, p, q, icpt, n_valid)


def css_neg_ll_value_and_grad_plain(params: torch.Tensor, y: torch.Tensor,
                                    p: int, q: int, icpt: int,
                                    n_valid: Optional[torch.Tensor] = None):
    """:func:`css_neg_ll_value_and_grad` over
    :func:`normal_equations_plain`, on any device."""
    return _css_neg_ll(normal_equations_plain, params, y, p, q, icpt,
                       n_valid)


# ---------------------------------------------------------------------------
# the CSS cost alone (the port of arma_pallas.py::_css_kernel, cost mode)
# ---------------------------------------------------------------------------

CSS_MAX_Q = 5             # q <= 5 (any p) in arma_css_kernel


@functools.lru_cache(maxsize=None)
def _css_kernel_fn():
    fn = _build.library("arma_ne").arma_css_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _css_launch(params_t: torch.Tensor, y_t: torch.Tensor,
                nv: Optional[torch.Tensor], p: int, q: int,
                icpt: int) -> torch.Tensor:
    """Launch the cost-only kernel of ``csrc/arma_ne.cu`` on the current
    stream; returns the ``(1, S)`` sse (not synchronised)."""
    if not (p >= 0 and 0 <= q <= CSS_MAX_Q) or icpt + p + q == 0:
        raise ValueError(
            f"the CUDA CSS-cost kernel takes q <= {CSS_MAX_Q} and at least "
            f"one parameter, got ARMA({p},{q}) icpt={icpt}")
    k = icpt + p + q
    n_obs, S = y_t.shape
    _build.check_inputs([y_t, params_t] + ([] if nv is None else [nv]),
                        "CSS-cost")
    if params_t.shape != (k, S) or (nv is not None and nv.shape != (S,)):
        raise ValueError(
            f"shape mismatch: params {tuple(params_t.shape)} (expected "
            f"{(k, S)}), y {tuple(y_t.shape)}")
    _check_window(n_obs, p, q)
    out = torch.empty((1, S), dtype=torch.float32, device=y_t.device)
    _build.launch(_css_kernel_fn(), y_t.device, params_t.data_ptr(),
                  y_t.data_ptr(), 0 if nv is None else nv.data_ptr(),
                  out.data_ptr(), S, n_obs, p, q, icpt,
                  what=f"arma_css kernel launch failed for ARMA({p},{q}) "
                       f"icpt={icpt} S={S} n_obs={n_obs}")
    css_cost.launches += 1
    return out


def _css_cost(launch, params, y, p, q, icpt, n_valid):
    _check_window(y.shape[-1], p, q)
    nv = None if n_valid is None else n_valid.to(y.dtype).contiguous()
    return launch(params.T.contiguous(), y.T.contiguous(), nv, p, q,
                  icpt)[0]


def css_cost(params: torch.Tensor, y: torch.Tensor, p: int, q: int,
             icpt: int, n_valid: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Batched CSS ``sum_{t >= max(p, q)} e_t²`` of the ARMA one-step
    residuals, ``(S,)``; ``params (S, k)``, ``y (S, n)``, ``n_valid (S,)``
    restricts each lane to its left-aligned valid window.

    A CUDA tensor launches the cost-only kernel (float32, ``q <= 5``;
    anything else raises) and adds one to ``css_cost.launches``; a CPU
    tensor runs :func:`css_cost_plain`."""
    if y.is_cuda:
        return _css_cost(_css_launch, params, y, p, q, icpt, n_valid)
    return css_cost_plain(params, y, p, q, icpt, n_valid)


css_cost.launches = 0


def css_cost_plain(params: torch.Tensor, y: torch.Tensor, p: int, q: int,
                   icpt: int, n_valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """:func:`css_cost` as plain tensor ops, on any device and float
    dtype — the version the kernel is held against."""
    return _css_cost(functools.partial(_packed_plain, grad=False), params,
                     y, p, q, icpt, n_valid)



# ---------------------------------------------------------------------------
# the CSS Levenberg-Marquardt fit (the port of pallas_arma.fit_css_lm)
# ---------------------------------------------------------------------------

# threads a block of the LM-fit kernel (PERF.md: on the H100, 128 and 256
# ran the 131072-lane chunk within 2 % of each other, 64 1-15 % slower)
LM_FIT_THREADS = 128


def _order_mask(grid_orders, S: int, S_y: int, p: int, q: int, icpt: int,
                dtype, device) -> torch.Tensor:
    """The ``(S, k)`` 0/1 mask of the slots each candidate's order owns in
    the padded ``[c?, AR(p), MA(q)]`` layout: candidate ``c``'s ``S_y``
    lanes own the intercept (with ``icpt``), their first ``p_c`` AR slots
    and their first ``q_c`` MA slots."""
    C = S // S_y
    orders = [(int(pc), int(qc)) for pc, qc in grid_orders]
    if len(orders) != C:
        raise ValueError(
            f"grid_orders has {len(orders)} candidates; x0's {S} lanes over "
            f"{S_y} series are {C}")
    for pc, qc in orders:
        if not (0 <= pc <= p and 0 <= qc <= q) or icpt + pc + qc == 0:
            raise ValueError(
                f"grid_orders candidate ARMA({pc},{qc}) with icpt={icpt} "
                f"does not fit the padded ARMA({p},{q}) layout or has no "
                f"parameter")
    rows = torch.zeros((C, icpt + p + q), dtype=dtype)
    for c, (pc, qc) in enumerate(orders):
        rows[c, :icpt + pc] = 1.0
        rows[c, icpt + p:icpt + p + qc] = 1.0
    return rows.to(device).repeat_interleave(S_y, dim=0)


def _lm_inputs(x0, y, p, q, icpt, mask, n_valid, grid_orders=None):
    """Validated ``(x0, mask, n_valid)`` of an LM fit, cast to ``y``'s
    dtype and with ``x0`` masked.  ``x0`` and ``mask`` have ``C·S`` lanes
    (candidate-major) over the ``S`` series of ``y`` and ``n_valid``;
    ``grid_orders`` multiplies the mask by each candidate's order mask
    (:func:`_order_mask`)."""
    S, k = x0.shape
    S_y, n_obs = y.shape
    if S_y == 0 or S % S_y:
        raise ValueError(
            f"x0 lane count {S} is not a multiple of the panel's {S_y} "
            f"series (a candidate grid has C·S lanes, candidate-major)")
    if k != icpt + p + q or (mask is not None and mask.shape != (S, k)) \
            or (n_valid is not None and n_valid.shape != (S_y,)):
        raise ValueError(
            f"shape mismatch: x0 {tuple(x0.shape)} (expected "
            f"{(S, icpt + p + q)}), mask "
            f"{None if mask is None else tuple(mask.shape)}, n_valid "
            f"{None if n_valid is None else tuple(n_valid.shape)} "
            f"(expected {(S_y,)})")
    _check_window(n_obs, p, q)
    x0 = x0.to(y.dtype)
    if grid_orders is not None:
        own = _order_mask(grid_orders, S, S_y, p, q, icpt, y.dtype, y.device)
        mask = own if mask is None else mask.to(y.dtype) * own
    if mask is not None:
        mask = mask.to(y.dtype)
        x0 = x0 * mask
    nv = None if n_valid is None else n_valid.to(y.dtype).contiguous()
    return x0, mask, nv


def _lm_loop(packed_fn, x0, y, p, q, icpt, tol, max_iter, mask, n_valid,
             grid_orders):
    """The batched LM loop with the normal equations from ``packed_fn``;
    a candidate grid gathers the panel to one copy per candidate."""
    x0, mask, nv = _lm_inputs(x0, y, p, q, icpt, mask, n_valid, grid_orders)
    S, k = x0.shape
    C = S // y.shape[0]
    if C > 1:
        y = y.repeat(C, 1)
        nv = None if nv is None else nv.repeat(C)
    y_t = y.T.contiguous()                  # (n_obs, S), once per fit

    def ne(x):
        if mask is not None:
            x = x * mask
        res = _unpack(packed_fn(x.T.contiguous(), y_t, nv, p, q, icpt), k)
        return _masked_ne(*res, mask) if mask is not None else res

    return lm_state_machine(ne, x0, tol, max_iter)


def fit_css_lm_plain(x0: torch.Tensor, y: torch.Tensor, p: int, q: int,
                     icpt: int, tol: float = 1e-6, max_iter: int = 50,
                     mask: Optional[torch.Tensor] = None,
                     n_valid: Optional[torch.Tensor] = None,
                     grid_orders: Optional[Sequence] = None):
    """:func:`fit_css_lm` as plain tensor ops, on any device and float
    dtype — the version the kernel is held against: the batched LM loop
    over :func:`normal_equations_plain`'s pass.  ``grid_orders`` is
    defined here: the mask times each candidate's order mask."""
    return _lm_loop(_packed_plain, x0, y, p, q, icpt, tol, max_iter, mask,
                    n_valid, grid_orders)


def fit_css_lm_route(x0: torch.Tensor, y: torch.Tensor, p: int, q: int,
                     icpt: int, tol: float = 1e-6, max_iter: int = 50,
                     mask: Optional[torch.Tensor] = None,
                     n_valid: Optional[torch.Tensor] = None,
                     grid_orders: Optional[Sequence] = None):
    """The same batched LM loop over :func:`normal_equations`' dispatch:
    on CUDA one ``arma_ne`` kernel launch up front and one per iteration,
    with the damped solves and updates as tensor ops and one host sync
    per iteration for the loop test.  The comparison route of the LM-fit
    kernel; on the CPU it equals :func:`fit_css_lm_plain`."""
    return _lm_loop(_packed, x0, y, p, q, icpt, tol, max_iter, mask,
                    n_valid, grid_orders)


@functools.lru_cache(maxsize=None)
def _lm_fns():
    lib = _build.library("arma_ne")
    config = lib.arma_lm_fit_config
    config.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    config.restype = ctypes.c_int
    launch = lib.arma_lm_fit_launch
    launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return config, launch


class LmFitConfig(NamedTuple):
    """The LM-fit kernel's launch (a thread a lane): threads a block,
    blocks, resident blocks per SM, SMs, registers and spill bytes a
    thread."""
    threads: int
    blocks: int
    blocks_per_sm: int
    sms: int
    registers: int
    local_bytes: int


def lm_fit_config(S: int, n_obs: int, p: int, q: int, icpt: int,
                  ragged: bool, device: torch.device,
                  threads: int = LM_FIT_THREADS) -> LmFitConfig:
    """How :func:`fit_css_lm` launches ``S`` lanes on ``device``'s card."""
    config, _ = _lm_fns()
    cfg = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = config(S, n_obs, p, q, icpt, int(ragged), threads, cfg)
    if rc != 0:
        raise _build.KernelError(
            f"arma_lm_fit configuration failed for ARMA({p},{q}) "
            f"icpt={icpt} S={S} threads={threads}: "
            + ("unsupported arguments" if rc < 0 else f"CUDA error {rc}"))
    return LmFitConfig(threads, *cfg)


def _lm_operands(x0: torch.Tensor, y: torch.Tensor,
                 nv: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                 in_place: bool = False):
    """The kernel's operands ``(x0, y, mask)``, slot- and time-major, and
    its outputs ``(x, fun, converged, n_iter)``; ``in_place`` writes
    ``x`` over the slot-major copy of ``x0``."""
    S = x0.shape[0]
    dev = y.device
    ops = (x0.T.contiguous(), y.T.contiguous(),
           None if mask is None else mask.T.contiguous())
    _build.check_inputs([ops[1], ops[0]] + [t for t in (ops[2], nv)
                                            if t is not None],
                        "ARMA LM fit")
    x = ops[0] if in_place else torch.empty_like(ops[0])
    return ops, (x, torch.empty((S,), dtype=torch.float32, device=dev),
                 torch.empty((S,), dtype=torch.bool, device=dev),
                 torch.empty((S,), dtype=torch.int32, device=dev))


def _lm_call(ops, nv, outs, p: int, q: int, icpt: int, tol: float,
             max_iter: int, threads: int, lane0: int, S: int,
             theta_slot: int, t0: int) -> None:
    """One LM-fit launch of ARMA(p, q) on the current stream over lanes
    ``lane0 .. lane0 + S - 1`` of the layout of ``outs``: it owns the
    intercept, the first ``p`` AR slots and the ``q`` MA slots from
    ``theta_slot`` on, over the CSS window from ``t0``."""
    x0_t, y_t, mask_t = ops
    x, fun, converged, n_iter = outs
    n_obs, S_y = y_t.shape
    _, launch = _lm_fns()
    _build.launch(launch, y_t.device, x0_t.data_ptr(), y_t.data_ptr(),
                  0 if nv is None else nv.data_ptr(),
                  0 if mask_t is None else mask_t.data_ptr(), x.data_ptr(),
                  fun.data_ptr(), converged.data_ptr(), n_iter.data_ptr(), S,
                  S_y, n_obs, p, q, icpt, float(tol), int(max_iter), lane0,
                  x.shape[1], theta_slot, t0, threads,
                  what=f"arma_lm_fit kernel launch failed for ARMA({p},{q}) "
                       f"icpt={icpt} S={S} lane0={lane0} S_y={S_y} "
                       f"n_obs={n_obs} threads={threads}")
    fit_css_lm.launches += 1


def _lm_launch(x0, y, p, q, icpt, tol, max_iter, mask, n_valid,
               threads: int = LM_FIT_THREADS):
    """Launch the LM-fit kernel once over every lane, on the current stream
    with ``threads`` a block (not synchronised); returns ``(x, fun,
    converged, n_iter)``."""
    check_kernel_order(p, q, icpt)
    x0, mask, nv = _lm_inputs(x0, y, p, q, icpt, mask, n_valid)
    ops, outs = _lm_operands(x0, y, nv, mask)
    _lm_call(ops, nv, outs, p, q, icpt, tol, max_iter, threads, 0,
             x0.shape[0], icpt + p, max(p, q))
    return (outs[0].T,) + outs[1:]


# side streams the per-candidate launches are spread over, so that one
# candidate's tail overlaps the next ones (PERF.md: on the H100 the default
# grid's screen took 57 ms over 2, 4 or 8 side streams and 62 ms with every
# launch on the caller's stream)
LM_GRID_STREAMS = 4


@functools.lru_cache(maxsize=None)
def _side_streams(device: torch.device, n: int) -> List[torch.cuda.Stream]:
    return [torch.cuda.Stream(device=device) for _ in range(n)]


def _lm_grid_launch(x0, y, p, q, icpt, tol, max_iter, mask, n_valid,
                    grid_orders):
    """The candidate grid as one LM-fit launch per candidate at its own
    order ``grid_orders[c] = (p_c, q_c)``, over the padded ARMA(p, q)
    layout, heaviest candidates first, spread over ``LM_GRID_STREAMS``
    side streams joined back to the caller's (not synchronised); returns
    ``(x, fun, converged, n_iter)``, the padded launch of
    :func:`_lm_launch` with the mask times each candidate's order mask
    (but for diverging lanes: see :func:`fit_css_lm`)."""
    check_kernel_order(p, q, icpt)
    x0, mask, nv = _lm_inputs(x0, y, p, q, icpt, mask, n_valid,
                              grid_orders)
    S_y = y.shape[0]
    # x0 is this call's own copy (x0 * mask), so the launches fit in
    # place: a lane reads its start before it writes its result, and the
    # slots no candidate owns keep x0 * mask, the padded launch's value
    ops, outs = _lm_operands(x0, y, nv, mask, in_place=True)
    orders = [(int(pc), int(qc)) for pc, qc in grid_orders]

    def cost(c):      # triu(JᵀJ) entries and MA tangent terms a step
        k_c = icpt + sum(orders[c])
        return k_c * (k_c + 1) // 2 + orders[c][1] * k_c

    caller = torch.cuda.current_stream(y.device)
    side = _side_streams(y.device, LM_GRID_STREAMS)[:len(orders)]
    for st in side:
        st.wait_stream(caller)
    for j, c in enumerate(sorted(range(len(orders)), key=lambda c: -cost(c))):
        with torch.cuda.stream(side[j % len(side)]):
            _lm_call(ops, nv, outs, *orders[c], icpt, tol, max_iter,
                     LM_FIT_THREADS, c * S_y, S_y, icpt + p, max(p, q))
    for st in side:
        caller.wait_stream(st)
        for t in ops + outs + (nv,):
            if t is not None:
                t.record_stream(st)
    return (outs[0].T,) + outs[1:]


def fit_css_lm(x0: torch.Tensor, y: torch.Tensor, p: int, q: int,
               icpt: int, tol: float = 1e-6, max_iter: int = 50,
               mask: Optional[torch.Tensor] = None,
               n_valid: Optional[torch.Tensor] = None,
               grid_orders: Optional[Sequence] = None):
    """Panel-batched Levenberg-Marquardt on the CSS residuals: per lane
    the state machine of ``pallas_arma.fit_css_lm`` (Marquardt-scaled
    damping, trial-point normal equations kept on accept, the pinned exit
    testing the pre-update λ, finished lanes frozen, at most ``max_iter``
    iterations).

    ``x0 (S, k)``, ``y (S, n)``; returns ``(x, fun, converged, n_iter)``
    with per-lane shapes.  ``mask (S, k)`` of 0/1 freezes parameter slots
    (the objective ``r(x ∘ mask)``); ``n_valid (S,)`` restricts each lane
    to its left-aligned valid window.

    ``x0`` and ``mask`` may carry ``C·S`` lanes, candidate-major, over
    the ``S`` series of ``y`` and ``n_valid`` (the auto-fit grid's shape,
    ``pallas_arma.fit_css_lm``'s ``y_blocks`` form): lane ``i`` fits
    series ``i % S``.  A lane count that is not a multiple of ``S``
    raises.  ``grid_orders``, a host sequence of ``C`` pairs ``(p_c,
    q_c)`` with ``p_c <= p`` and ``q_c <= q``, says which order candidate
    ``c`` fits: its lanes fit with the AR slots past ``p_c`` and the MA
    slots past ``q_c`` held at zero, as if the mask were zero there (the
    mask times each candidate's order mask); the CSS window stays the
    common ``t >= max(p, q)``.

    A CUDA tensor launches the LM-fit kernel of ``csrc/arma_ne.cu`` over
    the one unrepeated panel (float32, ``p, q <= 5``; anything else
    raises): once for the whole fit, or with ``grid_orders`` once per
    candidate at its own order; each launch adds one to
    ``fit_css_lm.launches``.  A CPU tensor runs :func:`fit_css_lm_plain`,
    which gathers the panel to one copy per candidate.

    A launch per candidate computes only the slots the candidate owns, so
    on a lane that diverges it differs from the plain LM and the padded
    launch, which also run the unowned slots' terms at zero and scale
    them by 0: where a term overflows, ``0 · inf`` makes NaN.  Such a
    lane reports ``fun`` inf where they report NaN; and where an unowned
    JᵀJ entry overflows at the current point (the NaN spreads through
    their step) or at the trial point (their finiteness test fails),
    they refuse a trial that the launch per candidate judges on its
    owned terms alone and may take (PERF.md)."""
    if y.is_cuda:
        if grid_orders is not None:
            return _lm_grid_launch(x0, y, p, q, icpt, tol, max_iter, mask,
                                   n_valid, grid_orders)
        return _lm_launch(x0, y, p, q, icpt, tol, max_iter, mask, n_valid)
    return fit_css_lm_plain(x0, y, p, q, icpt, tol, max_iter, mask, n_valid,
                            grid_orders)


fit_css_lm.launches = 0
