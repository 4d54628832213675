"""PyTorch/CUDA port of ``spark_timeseries_tpu``.

The JAX package beside this one is the reference; this package computes
the same functions on tensors, with the ARMA normal-equations pass as a
hand-written CUDA kernel (``csrc/arma_ne.cu``).  It imports neither
``jax`` nor ``spark_timeseries_tpu``.

Ported so far: the batched ARIMA(p, d, q) CSS fit (``models.arima.fit``,
``method="css-lm"``) and the streaming fit engine
(``engine.FitEngine.fit`` / ``stream_fit``) with the ops they need.

Device policy: the entry points take ``device=None``, which means CUDA.
Without a card they raise unless the caller passes ``device="cpu"``.
On CUDA, fits run in float32; on the CPU, float32 and float64 are both
allowed.
"""

from ._device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
