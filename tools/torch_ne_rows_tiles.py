"""Times the series-major one-pass ARMA kernels at each block shape.

``arma_ne_rows_kernel`` (``ops.arma_ne.normal_equations``) and
``arma_css_rows_kernel`` (``ops.arma_ne.css_cost``) take their block's
lane count from the launch's width (``csrc/stage_rows.cuh``:
``pick_lanes``, ``make_tile``) and stage the block's whole rows in
shared memory, or read rows too long to stage from global memory.  This
tool times each kernel at every lane count (32, 64, 128) against the
time-major kernels it replaced, at the widths the paths give it, on the
first series of ``chip_smoke.py``'s differenced ARIMA(2,1,2) panel
(``n_obs`` 127; ``--n-obs`` adds longer rows cut from a longer panel of
the same process), dense and ragged, and checks every result bit for bit
against the time-major kernel's.  On a card, from the root of the
repository::

    python3 tools/torch_ne_rows_tiles.py [--widths 131072 8192 1024]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per (kernel, n_obs, width, ragged) with the CUDA-event median of
``--reps`` launches at each lane count (``ms_by_lanes``, 0 the kernels'
own choice) and the median device time of as many under the profiler
(``device_us_by_lanes``), the tile the kernels pick, and the time-major
kernel's two medians.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LANES = (0, 32, 64, 128)


def _us(ms):
    """Microseconds of a device time in ms; None where the profiler
    recorded no kernel."""
    return None if ms is None else ms * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[131072, 8192, 1024])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-obs", type=int, nargs="+", default=[127],
                    help="row lengths (each timed at every width)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch.ops import arma_ne

    if not torch.cuda.is_available():
        print("torch_ne_rows_tiles: needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    S_max = max(args.widths)
    rng = np.random.default_rng(args.seed + 1)
    p, q, icpt = 2, 2, 1
    k = icpt + p + q
    prm_all = torch.from_numpy(
        (0.1 * rng.normal(size=(S_max, k))).astype(np.float32)).to(dev)
    for n_obs in args.n_obs:
        panel = cs.synthetic_arima_panel(S_max, n_obs + 1, args.seed)
        y_all = torch.from_numpy(
            np.ascontiguousarray(np.diff(panel, axis=1))).to(dev)
        nv_all = torch.from_numpy(rng.integers(
            40, n_obs + 1, S_max).astype(np.float32)).to(dev)
        for S in args.widths:
            _time_width(cs, arma_ne, y_all[:S].contiguous(),
                        prm_all[:S].contiguous(), nv_all[:S].contiguous(),
                        p, q, icpt, args.reps)
    return 0


def _time_width(cs, arma_ne, y, prm, nv_all, p, q, icpt, reps):
    import torch

    S, n_obs = y.shape
    k = icpt + p + q
    dev = y.device
    y_t, prm_t = y.T.contiguous(), prm.T.contiguous()
    for ragged in (False, True):
        nv = nv_all if ragged else None
        for cost in (False, True):
            if cost:
                old_fn = lambda: arma_ne._css_launch(  # noqa: E731
                    prm_t, y_t, nv, p, q, icpt)
                old = old_fn()[0]
            else:
                old_fn = lambda: arma_ne._launch(  # noqa: E731
                    prm_t, y_t, nv, p, q, icpt)
                old = arma_ne._unpack(old_fn(), k)
            row = {"kernel": "arma_css_rows" if cost else "arma_ne_rows",
                   "S": S, "n_obs": n_obs, "ragged": ragged,
                   "order": [p, q, icpt],
                   "tile": arma_ne.rows_tile(S, n_obs, p, q, icpt, cost,
                                             dev)._asdict(),
                   "time_major_ms": cs._event_ms(old_fn, reps),
                   "time_major_device_us": _us(cs._device_ms(old_fn, reps)),
                   "ms_by_lanes": {}, "device_us_by_lanes": {}}
            for lanes in LANES:
                if cost:
                    fn = lambda: arma_ne._css_rows(  # noqa: E731
                        prm, y, nv, p, q, icpt, lanes)
                else:
                    fn = lambda: arma_ne._ne_rows(  # noqa: E731
                        prm, y, nv, None, p, q, icpt, lanes)
                got = fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip((got,) if cost else got,
                                           (old,) if cost else old))
                if not same:
                    raise SystemExit(
                        f"{row['kernel']} S={S} n_obs={n_obs} "
                        f"ragged={ragged} lanes={lanes}: not bitwise the "
                        f"time-major kernel's")
                row["ms_by_lanes"][lanes] = cs._event_ms(fn, reps)
                row["device_us_by_lanes"][lanes] = _us(
                    cs._device_ms(fn, reps))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
