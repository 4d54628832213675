"""Fused Holt-Winters SSE value and gradient, and the whole box fit
(counterparts of the JAX package's
``models/holt_winters.py::_hw_sse_value_and_grad`` and of the Pallas pass
and panel fit loop in ``docs/experiments/hw_pallas.py``).

Every trial of the Holt-Winters projected-gradient fit needs, per lane,
the SSE of the one-step errors over ``t >= period`` and its gradient over
``(α, β, γ)``, which the hand tangent recurrences carry forward beside the
level, trend and season ring.  Two entry points run that pass, each a
hand-written kernel of ``csrc/hw_sse.cu`` on a CUDA tensor and a plain
PyTorch version on a CPU tensor, with no fallback between the two (a
kernel that fails to build or launch raises):

- :func:`value_and_grad`, one pass for a batch of parameter sets
  (``hw_sse_rows_kernel`` of ``csrc/hw_sse.rows.cu``, the port of the
  Pallas ``_hw_kernel``, reading the caller's ``(S, n)`` rows and
  ``(S, 3)`` parameters where they lie; plain:
  :func:`value_and_grad_plain`, a Python loop over steps on the lane
  batch).  The time-major ``hw_sse_kernel`` it replaced stays as its
  comparison (:func:`value_and_grad_time_major`, bit for bit);
- :func:`box_fit`, the whole projected-gradient fit of a panel
  (``hw_box_fit_kernel``: one persistent launch that runs every lane's
  solver state machine on the card; plain: :func:`box_fit_plain`,
  ``ops.optimize.minimize_box`` over the plain pass).  The fit of
  ``models.holt_winters`` runs this one.

The initial components depend on the data alone, so :func:`prepare`
computes them once per fit, with the time-major panel ``(n - m, S)`` the
box fit reads (or, for the one-pass kernel, a view of the caller's
rows); :func:`evaluator` then gives a solver its batched
``x (S, 3) -> (f (S,), g (S, 3))``.  What bounds the kernels on the H100
is written in the source note of ``csrc/hw_sse.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .lag import lag_matrix
from .optimize import MinimizeResult, minimize_box

# periods whose ring the time-major and box-fit kernels keep in
# registers; any other runs their generic form with its ring in a scratch
# buffer
REGISTER_PERIODS = (4, 7, 12, 24)

# threads a block of the box-fit kernel, in order of preference: the
# first whose shared tile fits (PERF.md: 256 ran the 131072-lane monthly
# chunk fastest on the H100, 64 and 128 about 15 % slower)
BOX_FIT_THREADS = (256, 128, 64)

# On the CPU a call of the plain pass costs about the same for any lane
# batch up to a few thousand lanes, so box_fit_plain evaluates several
# line-search trials per call there: up to this many (trial, lane) pairs.
CPU_TRIAL_LANES = 4096


def check_model_type(model_type: str) -> bool:
    """``True`` for additive, ``False`` for multiplicative; anything else
    raises, as ``HoltWintersModel.additive`` does."""
    t = model_type.lower()
    if t not in ("additive", "multiplicative"):
        raise ValueError(f"Invalid model type: {model_type}")
    return t == "additive"


def _kernel(period: int) -> np.ndarray:
    """Centered moving-average weights (the reference's
    ``HoltWinters.scala:228-237``)."""
    if period % 2 == 0:
        k = np.full(period + 1, 1.0 / period)
        k[0] = k[-1] = 0.5 / period
        return k
    return np.full(period, 1.0 / period)


def init_components(ts: torch.Tensor, period: int, additive: bool):
    """Initial ``(level, trend, season[period])`` from the first two
    periods: convolution detrend, paired seasonal means, a simple linear
    regression on the trend window.  ``ts (..., n)`` with ``n >= 2 m``."""
    if ts.shape[-1] < 2 * period:
        raise ValueError(
            f"Holt-Winters initialization needs two periods: at least "
            f"{2 * period} observations, got {ts.shape[-1]}")
    window = ts[..., :2 * period]
    kernel = torch.as_tensor(_kernel(period), dtype=ts.dtype,
                             device=ts.device)
    ksize = kernel.shape[0]
    out_len = 2 * period - ksize + 1
    # lag_matrix row r = window[r+ksize-1 .. r] — reversed windows, which
    # the symmetric kernel makes equivalent to a forward convolution
    trend = lag_matrix(window, ksize - 1, include_original=True) @ kernel
    n_pad = (ksize - 1) // 2
    padded = F.pad(trend, (n_pad, n_pad))
    zero = torch.zeros((), dtype=ts.dtype, device=ts.device)
    nz = padded != 0
    if additive:
        removed = torch.where(nz, window - padded, zero)
    else:
        removed = torch.where(nz, window / torch.where(nz, padded, 1.0),
                              zero)
    first, second = removed[..., :period], removed[..., period:]
    either_zero = (first == 0) | (second == 0)
    seasonal_mean = torch.where(either_zero, first + second,
                                (first + second) / 2.0)
    mean_of = seasonal_mean.sum(dim=-1, keepdim=True) / period
    init_season = (seasonal_mean - mean_of) if additive \
        else seasonal_mean / mean_of
    idx = torch.arange(1, out_len + 1, dtype=ts.dtype, device=ts.device)
    xbar = idx.mean()
    ybar = trend.mean(dim=-1, keepdim=True)
    xxbar = ((idx - xbar) ** 2).sum()
    xybar = ((idx - xbar) * (trend - ybar)).sum(dim=-1)
    init_trend = xybar / xxbar
    init_level = ybar[..., 0] - init_trend * xbar
    return init_level, init_trend, init_season


class HWInputs(NamedTuple):
    """A panel prepared for the pass: ``y (n - m, S)`` = ``series[:, m:]``
    laid out time-major (or a transposed view of the caller's rows, see
    :func:`prepare`), ``init (2 + m, S)`` = (level0, trend0, season0[m]),
    ``n_valid (S,)`` or None."""
    y: torch.Tensor
    init: torch.Tensor
    n_valid: Optional[torch.Tensor]
    period: int
    additive: bool


def prepare(series: torch.Tensor, period: int, model_type: str,
            n_valid: Optional[torch.Tensor] = None,
            time_major: bool = True) -> HWInputs:
    """Validate ``series (S, n)`` (left-aligned and zero-tailed where
    ``n_valid`` is given) and compute its initial components — once per
    fit.  ``time_major`` copies ``series[:, m:]`` time-major, the layout
    the box-fit kernel reads; otherwise ``y`` is the view
    ``series[:, m:].T`` of the caller's rows, which the one-pass kernel
    reads where it lies."""
    additive = check_model_type(model_type)
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    S, n = series.shape
    if n - period < 1:
        raise ValueError(
            f"series too short for Holt-Winters: need more than period = "
            f"{period} observations, got {n}")
    level0, trend0, season0 = init_components(series, period, additive)
    init = torch.cat([level0[None], trend0[None], season0.T]).contiguous()
    nv = None if n_valid is None \
        else n_valid.to(series.dtype).reshape(S).contiguous()
    y = series[:, period:].T
    return HWInputs(y.contiguous() if time_major else y, init, nv, period,
                    additive)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.library("hw_sse").hw_sse_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rows_fns():
    lib = _build.library("hw_sse")
    config = lib.hw_sse_rows_config
    config.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    config.restype = ctypes.c_int
    launch = lib.hw_sse_rows_launch
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    launch.argtypes = [ptr, i64, i64, ptr, ptr, i64, i64, ptr, ptr, ptr] \
        + [ctypes.c_int] * 4 + [ptr]
    launch.restype = ctypes.c_int
    time_major = lib.hw_sse_config
    time_major.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    time_major.restype = ctypes.c_int
    return config, launch, time_major


class SseConfig(NamedTuple):
    """The one-pass kernel's launch on a prepared panel: lanes (threads)
    a block, whether the season ring sits in shared memory (else in a
    global scratch), dynamic shared bytes a block, blocks, resident
    blocks per SM, SMs, registers and spill bytes a thread."""
    lanes: int
    ring_in_smem: bool
    smem_bytes: int
    blocks: int
    blocks_per_sm: int
    sms: int
    registers: int
    local_bytes: int

    @property
    def resident_lanes(self) -> int:
        return self.blocks_per_sm * self.sms * self.lanes

    @property
    def waves(self) -> float:
        return self.blocks / max(1, self.blocks_per_sm * self.sms)


def _config_error(what: str, rc: int) -> _build.KernelError:
    return _build.KernelError(
        f"{what}: " + ("unsupported arguments" if rc < 0
                       else f"CUDA error {rc}"))


def sse_config(S: int, period: int, additive: bool, ragged: bool,
               rows: bool = True, device=None) -> SseConfig:
    """How :func:`value_and_grad` launches on ``S`` lanes at ``period`` on
    ``device``'s card: ``rows`` for a series-major ``y`` (step stride 1,
    the caller's rows), else time-major."""
    return _sse_config(S, period, bool(additive), bool(ragged), bool(rows),
                       torch.device(device or "cuda").index or 0)


@functools.lru_cache(maxsize=256)
def _sse_config(S, period, additive, ragged, rows, index):
    config, _, _ = _rows_fns()
    cfg = (ctypes.c_int * 8)()
    with torch.cuda.device(index):
        rc = config(S, period, int(additive), int(ragged), int(rows), cfg)
    if rc != 0:
        raise _config_error(f"hw_sse_rows configuration failed for period "
                            f"{period} S={S}", rc)
    return SseConfig(cfg[0], bool(cfg[1]), *cfg[2:])


def sse_config_time_major(S: int, period: int, additive: bool,
                          ragged: bool, device=None) -> SseConfig:
    """The time-major ``hw_sse_kernel``'s instantiation for ``period``
    (its ring in registers for :data:`REGISTER_PERIODS`, else in its
    ``(4m, S)`` scratch) as an :class:`SseConfig` at ``S`` lanes."""
    _, _, time_major = _rows_fns()
    cfg = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = time_major(period, int(additive), int(ragged), cfg)
    if rc != 0:
        raise _config_error(f"hw_sse configuration failed for period "
                            f"{period}", rc)
    threads = cfg[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return SseConfig(threads, period in REGISTER_PERIODS, 0,
                     -(-S // threads), cfg[1], sms, cfg[2], cfg[3])


def _launch(params_t: torch.Tensor, inp: HWInputs) -> torch.Tensor:
    """Launch ``hw_sse_rows_kernel`` on the current stream on
    ``params_t (3, S)`` and ``inp.y (n - m, S)`` at their strides (the
    caller's rows or a time-major copy); returns the ``(4, S)`` output
    (not synchronised)."""
    y, m = inp.y, inp.period
    n_steps, S = y.shape
    _build.check_inputs([inp.init]
                        + ([] if inp.n_valid is None else [inp.n_valid]),
                        "Holt-Winters")
    for t in (y, params_t):
        if t.device != inp.init.device or t.dtype != torch.float32:
            raise _build.KernelInputError(
                f"the CUDA Holt-Winters kernel takes float32 operands on one "
                f"device, got {t.dtype} on {t.device}")
    if params_t.shape != (3, S) or inp.init.shape != (2 + m, S):
        raise ValueError(
            f"shape mismatch: params {tuple(params_t.shape)} (expected "
            f"{(3, S)}), init {tuple(inp.init.shape)}, y "
            f"{tuple(y.shape)}")
    dev = y.device
    cfg = sse_config(S, m, inp.additive, inp.n_valid is not None,
                     y.stride(0) == 1, dev)
    out = torch.empty((4, S), dtype=torch.float32, device=dev)
    ring = None if cfg.ring_in_smem else torch.empty(
        (m, cfg.blocks * cfg.lanes, 4), dtype=torch.float32, device=dev)
    _, launch, _ = _rows_fns()
    _build.launch(launch, dev, params_t.data_ptr(), params_t.stride(0),
                  params_t.stride(1), inp.init.data_ptr(), y.data_ptr(),
                  y.stride(0), y.stride(1),
                  0 if inp.n_valid is None else inp.n_valid.data_ptr(),
                  0 if ring is None else ring.data_ptr(), out.data_ptr(), S,
                  n_steps, m, int(inp.additive),
                  what=f"hw_sse_rows kernel launch failed for period {m} "
                       f"S={S} n_steps={n_steps}")
    value_and_grad.launches += 1
    return out


def _launch_time_major(params_t: torch.Tensor,
                       inp: HWInputs) -> torch.Tensor:
    """Launch the time-major ``hw_sse_kernel`` of ``csrc/hw_sse.cu`` on the
    current stream (contiguous ``params_t (3, S)`` and time-major
    ``inp.y``); returns the ``(4, S)`` output (not synchronised)."""
    n_steps, S = inp.y.shape
    m = inp.period
    _build.check_inputs([inp.y, params_t, inp.init]
                        + ([] if inp.n_valid is None else [inp.n_valid]),
                        "Holt-Winters")
    if params_t.shape != (3, S) or inp.init.shape != (2 + m, S):
        raise ValueError(
            f"shape mismatch: params {tuple(params_t.shape)} (expected "
            f"{(3, S)}), init {tuple(inp.init.shape)}, y "
            f"{tuple(inp.y.shape)}")
    dev = inp.y.device
    out = torch.empty((4, S), dtype=torch.float32, device=dev)
    ring = None if m in REGISTER_PERIODS \
        else torch.empty((4 * m, S), dtype=torch.float32, device=dev)
    _build.launch(_kernel_fn(), dev, params_t.data_ptr(),
                  inp.init.data_ptr(), inp.y.data_ptr(),
                  0 if inp.n_valid is None else inp.n_valid.data_ptr(),
                  0 if ring is None else ring.data_ptr(), out.data_ptr(), S,
                  n_steps, m, int(inp.additive),
                  what=f"hw_sse kernel launch failed for period {m} S={S} "
                       f"n_steps={n_steps}")
    value_and_grad_time_major.launches += 1
    return out


def _dual_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Product of two dual numbers ``(4, S)``: ``[u v; du v + u dv]``."""
    out = u * v[0]
    out[1:].addcmul_(u[0], v[1:])
    return out


def _dual_div(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x / v`` for a constant ``x (S,)`` and a dual ``v``:
    ``[x / v; -(x / v²) dv]``."""
    out = v * -(x / (v[0] * v[0]))
    out[0] = x / v[0]
    return out


def _packed_plain(params_t: torch.Tensor, inp: HWInputs) -> torch.Tensor:
    """The kernel's recurrence as plain tensor ops over the lane batch,
    step by step in the kernel's order; any float dtype and device.

    Each quantity is a dual number: row 0 its value, rows 1-3 its tangent
    over (α, β, γ), so one op advances both (the unit-vector terms of the
    tangent recurrences land on their own row).  ``params_t`` is
    ``(3, S)``, or ``(3, K, S)`` for K parameter sets per lane, which the
    panel broadcasts against; the output is ``(4, S)`` or ``(4, K, S)``."""
    y, m, additive = inp.y, inp.period, inp.additive
    n_steps, S = y.shape
    a, b, g = params_t[0], params_t[1], params_t[2]
    one_m_a, one_m_b, one_m_g = 1.0 - a, 1.0 - b, 1.0 - g
    shape = (4, *torch.broadcast_shapes(a.shape, (S,)))
    unit = torch.eye(4, dtype=y.dtype, device=y.device).reshape(
        4, 4, *([1] * (len(shape) - 1)))
    e_a, e_b, e_g = unit[1], unit[2], unit[3]
    xs = y.new_zeros((n_steps, 4, *([1] * (len(shape) - 2)), S))
    xs[:, 0] = y.reshape(xs[:, 0].shape)         # x as a constant dual

    def dual(value):
        d = y.new_zeros(shape)
        d[0] = value
        return d

    level, trend = dual(inp.init[0]), dual(inp.init[1])
    ring = [dual(s) for s in inp.init[2:]]       # slot t mod m
    acc = y.new_zeros(shape)                     # Σ e², Σ e·de
    for t in range(n_steps):
        x, xd = y[t], xs[t]
        s = ring[t % m]
        base = level + trend
        if additive:
            e = xd - (base + s)
            lw = xd - s
        else:
            e = xd - _dual_mul(base, s)
            lw = _dual_div(x, s)
        new_level = torch.addcmul(one_m_a * base, a, lw)
        new_level = torch.addcmul(new_level, e_a, lw[0] - base[0])
        step = new_level - level
        new_trend = torch.addcmul(one_m_b * trend, b, step)
        new_trend = torch.addcmul(new_trend, e_b, step[0] - trend[0])
        sw = xd - new_level if additive else _dual_div(x, new_level)
        new_season = torch.addcmul(one_m_g * s, g, sw)
        ring[t % m] = torch.addcmul(new_season, e_g, sw[0] - s[0])
        level, trend = new_level, new_trend
        if inp.n_valid is not None:
            e = e * (m + t < inp.n_valid).to(y.dtype)
        acc.addcmul_(e[0], e)
    acc[1:] *= 2.0
    return acc


def _packed(params_t: torch.Tensor, inp: HWInputs) -> torch.Tensor:
    """Device dispatch: the kernel for CUDA tensors, the plain loop for
    CPU tensors."""
    if inp.y.is_cuda:
        return _launch(params_t, inp)
    return _packed_plain(params_t, inp)


def evaluator(inp: HWInputs, packed_fn=_packed):
    """The batched ``x (S, 3) -> (sse (S,), grad (S, 3))`` of a prepared
    panel, for ``ops.optimize.minimize_box``.  The plain version also takes
    ``x (K, S, 3)``, K parameter sets per lane."""
    def vag(x: torch.Tensor):
        out = packed_fn(x.to(inp.y.dtype).movedim(-1, 0), inp)
        return out[0], out[1:].movedim(0, -1)
    return vag


def value_and_grad(params: torch.Tensor, series: torch.Tensor, period: int,
                   model_type: str, n_valid: Optional[torch.Tensor] = None):
    """Batched ``(sse (S,), dsse/d(α, β, γ) (S, 3))`` of the Holt-Winters
    one-step errors over ``t >= period``; ``params (S, 3)``,
    ``series (S, n)``.

    A CUDA tensor launches the kernel (float32 only; anything else raises)
    and adds one to ``value_and_grad.launches``; it reads ``series`` and
    ``params`` where they lie (no time-major copy).  A CPU tensor runs
    :func:`value_and_grad_plain`.  ``n_valid (S,)`` restricts each
    left-aligned lane's accumulators to its valid window
    (``ops.ragged``)."""
    return evaluator(prepare(series, period, model_type, n_valid,
                             time_major=False))(params)


value_and_grad.launches = 0


def value_and_grad_time_major(params: torch.Tensor, series: torch.Tensor,
                              period: int, model_type: str,
                              n_valid: Optional[torch.Tensor] = None):
    """:func:`value_and_grad` as it ran before ``hw_sse_rows_kernel``: the
    panel copied time-major, ``params`` to ``(3, S)``, then the time-major
    ``hw_sse_kernel`` — the comparison of the one-pass kernel (equal bit
    for bit), on CUDA tensors only; it counts into its own
    ``launches``."""
    if not series.is_cuda:
        raise ValueError("the time-major hw_sse kernel runs on a card: "
                         "pass CUDA tensors")
    inp = prepare(series, period, model_type, n_valid)
    out = _launch_time_major(params.to(inp.y.dtype).T.contiguous(), inp)
    return out[0], out[1:].movedim(0, -1)


value_and_grad_time_major.launches = 0


def value_and_grad_plain(params: torch.Tensor, series: torch.Tensor,
                         period: int, model_type: str,
                         n_valid: Optional[torch.Tensor] = None):
    """:func:`value_and_grad` as plain tensor ops, on any device and
    float dtype — the version the kernel is held against."""
    return evaluator(prepare(series, period, model_type, n_valid),
                     _packed_plain)(params)


@functools.lru_cache(maxsize=None)
def _box_fns():
    lib = _build.library("hw_sse")
    config = lib.hw_box_fit_config
    config.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    config.restype = ctypes.c_int
    launch = lib.hw_box_fit_launch
    launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return config, launch


class BoxFitConfig(NamedTuple):
    """The box-fit kernel's launch for a prepared panel: threads and
    blocks (the resident blocks, at most the lanes' worth and the
    caller's cap), the dynamic shared tile in bytes (0: the series too
    long for it, read from global memory), resident blocks per SM, SMs,
    registers and spill bytes a thread."""
    threads: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    sms: int
    registers: int
    local_bytes: int


def box_fit_config(inp: HWInputs, threads: Optional[int] = None,
                   max_blocks: int = 0) -> BoxFitConfig:
    """How :func:`box_fit` launches on ``inp``'s card: ``threads`` a
    block, or (None) the first of :data:`BOX_FIT_THREADS` whose shared
    tile fits, else the last; ``max_blocks`` > 0 caps the grid, so fewer
    threads share the lane queue."""
    n_steps, S = inp.y.shape
    config, _ = _box_fns()
    for t in BOX_FIT_THREADS if threads is None else (threads,):
        cfg = (ctypes.c_int * 6)()
        with torch.cuda.device(inp.y.device):
            rc = config(S, n_steps, inp.period, int(inp.additive),
                        int(inp.n_valid is not None), t, max_blocks, cfg)
        if rc != 0:
            raise _build.KernelError(
                f"hw_box_fit configuration failed for period {inp.period} "
                f"S={S} n_steps={n_steps} threads={t}: "
                + ("unsupported arguments" if rc < 0
                   else f"CUDA error {rc}"))
        if cfg[1] > 0:          # the tile fits
            break
    return BoxFitConfig(t, *cfg)


def _box_launch(inp: HWInputs, x0: torch.Tensor, lower: float,
                upper: float, tol: float, max_iter: int,
                max_backtracks: int, threads: Optional[int] = None,
                max_blocks: int = 0, thread_evals: bool = False):
    """Launch the box-fit kernel on the current stream (not
    synchronised) with :func:`box_fit_config`'s grid; returns
    ``(MinimizeResult, evaluations (S,), evaluations per thread
    (blocks * threads,) or None)``."""
    n_steps, S = inp.y.shape
    m = inp.period
    x0_t = x0.movedim(-1, 0).contiguous()
    _build.check_inputs([inp.y, x0_t, inp.init]
                        + ([] if inp.n_valid is None else [inp.n_valid]),
                        "Holt-Winters box fit")
    if x0_t.shape != (3, S) or inp.init.shape != (2 + m, S):
        raise ValueError(
            f"shape mismatch: x0 {tuple(x0.shape)} (expected {(S, 3)}), "
            f"init {tuple(inp.init.shape)}, y {tuple(inp.y.shape)}")
    cfg = box_fit_config(inp, threads, max_blocks)
    dev = inp.y.device
    n_threads = cfg.blocks * cfg.threads
    ring = None if m in REGISTER_PERIODS else torch.empty(
        (4 * m, n_threads), dtype=torch.float32, device=dev)
    x = torch.empty((3, S), dtype=torch.float32, device=dev)
    fun = torch.empty((S,), dtype=torch.float32, device=dev)
    converged = torch.empty((S,), dtype=torch.bool, device=dev)
    n_iter = torch.empty((S,), dtype=torch.int32, device=dev)
    evaluations = torch.empty((S,), dtype=torch.int32, device=dev)
    per_thread = torch.empty((n_threads,), dtype=torch.int32, device=dev) \
        if thread_evals else None
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    _, launch = _box_fns()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    _build.launch(launch, dev, x0_t.data_ptr(), inp.init.data_ptr(),
                  inp.y.data_ptr(), ptr(inp.n_valid), ptr(ring),
                  x.data_ptr(), fun.data_ptr(), converged.data_ptr(),
                  n_iter.data_ptr(), evaluations.data_ptr(),
                  ptr(per_thread), head.data_ptr(), S, n_steps, m,
                  int(inp.additive), float(lower), float(upper), float(tol),
                  int(max_iter), int(max_backtracks), cfg.threads,
                  max_blocks,
                  what=f"hw_box_fit kernel launch failed for period {m} "
                       f"S={S} n_steps={n_steps}")
    box_fit.launches += 1
    return MinimizeResult(x.T, fun, converged, n_iter), evaluations, \
        per_thread


def box_fit_plain(inp: HWInputs, x0: torch.Tensor, lower: float = 0.0,
                  upper: float = 1.0, tol: float = 1e-10,
                  max_iter: int = 1000, max_backtracks: int = 40,
                  stats: Optional[dict] = None):
    """:func:`box_fit` as plain tensor ops, on any device and float
    dtype — the version the kernel is held against: ``minimize_box`` over
    the plain pass, evaluating up to :data:`CPU_TRIAL_LANES` (trial,
    lane) pairs per call (the same per-lane result as one trial per
    call).  ``stats`` receives the solver's counts."""
    st = {} if stats is None else stats
    res = minimize_box(evaluator(inp, _packed_plain), x0, lower, upper,
                       tol=tol, max_iter=max_iter,
                       max_backtracks=max_backtracks,
                       trials_per_call=max(1, CPU_TRIAL_LANES
                                           // x0.shape[0]),
                       stats=st)
    return res, st["evaluations"]


def box_fit(inp: HWInputs, x0: torch.Tensor, lower: float = 0.0,
            upper: float = 1.0, tol: float = 1e-10, max_iter: int = 1000,
            max_backtracks: int = 40, stats: Optional[dict] = None):
    """The Holt-Winters projected-gradient fit of a prepared panel from
    ``x0 (S, 3)`` on the box ``[lower, upper]³``: per lane the state
    machine of ``ops.optimize.minimize_box`` (the JAX package's
    ``_minimize_box_one``).  Returns ``(MinimizeResult, evaluations)``,
    ``evaluations (S,)`` the value-and-grad passes each lane needed (1
    plus its trials up to and including each accepted one).

    A CUDA tensor launches the persistent kernel once for the whole fit
    (float32 only; anything else raises) and adds one to
    ``box_fit.launches``.  A CPU tensor runs :func:`box_fit_plain`.
    ``stats`` receives ``evaluations`` and the route's counts:
    ``box_fit_launches`` on CUDA, the solver's ``calls``, ``iterations``
    and ``trials`` on the CPU."""
    if inp.y.is_cuda:
        res, evaluations, _ = _box_launch(inp, x0, lower, upper, tol,
                                          max_iter, max_backtracks)
        if stats is not None:
            stats.update(box_fit_launches=1, evaluations=evaluations)
        return res, evaluations
    return box_fit_plain(inp, x0, lower, upper, tol, max_iter,
                         max_backtracks, stats)


box_fit.launches = 0
