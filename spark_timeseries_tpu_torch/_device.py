"""Device and dtype policy shared by the port's entry points.

``None`` means CUDA.  A CUDA request without a card raises: there is no
silent CPU path, so a caller who wants the CPU says ``device="cpu"``.
Fits on the card run in float32 (the only dtype the ARMA kernel takes,
as ``pallas_arma.route_mode`` admits only float32 for the Pallas kernel);
float64 is allowed on the CPU, where the tests hold the port against the
JAX package at float64.
"""

from __future__ import annotations

import torch


class KernelError(RuntimeError):
    """A kernel of the port failed to build, load, configure or launch.
    Stage and chunk isolation never catch it: a fit that cannot reach
    its kernel raises instead of serving a fallback."""


class KernelInputError(KernelError, ValueError):
    """Operands a kernel does not take (dtype, device, layout)."""


def is_device_fault(e: BaseException) -> bool:
    """Whether ``e`` is a failure of a kernel or of the card, which
    isolation re-raises, rather than a failure of one stage's numbers."""
    return isinstance(e, (KernelError, torch.cuda.OutOfMemoryError,
                          getattr(torch, "AcceleratorError", ())))


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on (``None`` -> CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none."""
    return resolve_device(None)


def check_dtype(dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``dtype`` is a float dtype the device's fits take."""
    if not dtype.is_floating_point:
        raise ValueError(f"panels must be floating point, got {dtype}")
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(
            f"fits on CUDA run in float32, got {dtype}; cast the panel to "
            f"float32 (float64 on the card is not supported yet)")


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a float tensor on ``device``, after
    the dtype check — an unsupported dtype raises before any copy."""
    t = torch.as_tensor(x)
    check_dtype(t.dtype, device)
    return t.to(device)
