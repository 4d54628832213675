"""Times the segment Hessians of ``models.arima.fit_long`` both ways.

``arima.fit_long`` weights each segment's CSS estimate by the exact
Hessian of its negative CSS log likelihood, which ``ARIMAModel.
coefficient_precision`` computes by a forward second-order recursion
over log-depth scans (``arima._css_hessian``).  The straightforward way
is autograd through the residual step loop (``arima._one_step_errors``:
one graph of ~7 launches a step, then k + 1 backward passes), which this
tool keeps as :func:`_autograd_hessian` to time it.  It fits
``bench_suite.py``'s ``fit_long`` configuration (ARIMA(2,1,2) segments
of 16384 observations of 8 series of 262144, ``synthetic_arima_panel``
at seed 7: 120 segments), then times both Hessians at the segments'
fitted coefficients with CUDA synchronisation around each, the autograd
one in a child process under ``--autograd-timeout`` seconds, and
compares the two matrices.  On a card, from the root of the
repository::

    python3 tools/torch_long_hessian_timing.py [--steps 16384]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line: seconds of each Hessian (``autograd_s`` null when the child ran
past its timeout), and the largest difference of the two relative to
each lane's largest entry.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _segments(steps: int, device):
    """The fitted segments: ``(coefficients (K, 5), segments (K, steps))``
    on ``device``, float32."""
    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch.models import arima

    vals = cs.synthetic_arima_panel(cs.ULTRA_SERIES, cs.ULTRA_OBS,
                                    cs.ULTRA_SEED)
    diffed = np.diff(vals, axis=1)
    k = diffed.shape[1] // cs.ULTRA_SEG
    segs = diffed[:, -k * cs.ULTRA_SEG:].reshape(-1, cs.ULTRA_SEG)
    segs = torch.from_numpy(np.ascontiguousarray(segs)).to(device)
    m = arima.fit(2, 0, 2, segs, warn=False, device=device)
    return m.coefficients, segs[:, :steps].contiguous()


def _timed(fn, device):
    import torch

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _autograd_hessian(params, y, p: int, q: int, icpt: int):
    """The Hessian of the negative CSS log likelihood by autograd
    through the residual step loop: every lane's likelihood in one graph
    (lanes are independent, so the gradient of their sum separates by
    lane), one backward with its graph kept for the gradient, then one
    backward per coefficient for the Hessian's rows."""
    import math

    import torch

    from spark_timeseries_tpu_torch.models import arima

    k = params.shape[-1]
    n = float(y.shape[-1])
    with torch.enable_grad():
        x = params.detach().clone().requires_grad_(True)
        _, err = arima._one_step_errors(x, y, p, q, icpt)
        css = (err * err).sum(dim=-1)
        f = ((n / 2.0) * torch.log(2.0 * math.pi * css / n)
             + n / 2.0).sum()
        (g,) = torch.autograd.grad(f, x, create_graph=True)
        rows = [torch.autograd.grad(g[..., j].sum(), x,
                                    retain_graph=j + 1 < k)[0]
                for j in range(k)]
    return torch.stack(rows, dim=-2).detach()


def _autograd_child(steps: int, out_path: str) -> int:
    import torch

    dev = torch.device("cuda")
    coefs, segs = _segments(steps, dev)
    H, secs = _timed(lambda: _autograd_hessian(coefs, segs, 2, 2, 1), dev)
    np.save(out_path, H.cpu().numpy())
    print(json.dumps({"autograd_s": secs}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16384,
                    help="leading steps of each segment the Hessians see")
    ap.add_argument("--autograd-timeout", type=float, default=240.0)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _autograd_child(args.steps, args.child)

    import tempfile

    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch.models import arima

    if not torch.cuda.is_available():
        print("torch_long_hessian_timing: needs a card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    coefs, segs = _segments(args.steps, dev)
    model = arima.ARIMAModel(2, 0, 2, coefs, True)
    model.coefficient_precision(segs, assume_differenced=True)   # warm-up
    H, rec_s = _timed(lambda: model.coefficient_precision(
        segs, assume_differenced=True), dev)
    row = {"segments": int(segs.shape[0]), "steps": int(segs.shape[1]),
           "recursion_s": rec_s, "autograd_s": None,
           "autograd_timeout_s": args.autograd_timeout}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "h.npy")
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--steps",
                 str(args.steps), "--child", path],
                capture_output=True, text=True,
                timeout=args.autograd_timeout)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("{")]
            if out.returncode == 0 and lines:
                row["autograd_s"] = json.loads(lines[-1])["autograd_s"]
                Ha = torch.from_numpy(np.load(path)).to(dev)
                scale = Ha.abs().amax(dim=(-2, -1), keepdim=True)
                row["max_rel_diff"] = float(((H - Ha).abs() / scale).max())
            else:
                row["autograd_error"] = out.stderr[-2000:]
        except subprocess.TimeoutExpired:
            pass
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
