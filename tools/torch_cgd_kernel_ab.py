"""css-cgd over the series-major one-pass kernel against css-cgd over the
time-major one, on one card.

``models.arima.fit(2, 1, 2, chunk, method="css-cgd")`` on the first
chunk of ``chip_smoke.py``'s ARIMA panel runs three ways, each its own
BFGS from the same start:

- ``series_major``: the fit as it is, through
  ``ops.arma_ne.css_neg_ll_value_and_grad`` (``arma_ne_rows_kernel``);
  at every BFGS call the time-major kernel runs on the same inputs
  beside it and the two normal equations are held bit for bit;
- ``time_major``: the same objective over
  ``normal_equations_time_major`` (the transposes, ``arma_ne_kernel``
  and the unpack), whose gradient comes back as a transposed view;
- ``time_major_contiguous``: the same, its gradient made contiguous.

On a card, from the root of the repository::

    python3 tools/torch_cgd_kernel_ab.py [--lanes 131072] [--seed 0]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line: BFGS calls of each run, the share of lanes whose coefficients
(NaN matching NaN) and iteration counts equal each other run's, and the
calls whose normal equations differed between the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    if not torch.cuda.is_available():
        print("torch_cgd_kernel_ab: needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    panel = cs.synthetic_arima_panel(args.lanes, cs.N_OBS, args.seed)
    part = torch.from_numpy(panel).to(dev)
    real = arima.css_neg_ll_value_and_grad
    parted = []

    def series_major(params, y, p, q, icpt, n_valid=None):
        new = arma_ne.normal_equations(params, y, p, q, icpt,
                                       n_valid=n_valid)
        old = arma_ne.normal_equations_time_major(params, y, p, q, icpt,
                                                  n_valid=n_valid)
        if not cs._bits_equal(new, old):
            parted.append(len(parted))
        return real(params, y, p, q, icpt, n_valid=n_valid)

    def time_major(params, y, p, q, icpt, n_valid=None):
        return arma_ne._css_neg_ll(arma_ne.normal_equations_time_major,
                                   params, y, p, q, icpt, n_valid)

    def time_major_contiguous(params, y, p, q, icpt, n_valid=None):
        f, g = time_major(params, y, p, q, icpt, n_valid)
        return f, g.contiguous()

    runs = {}
    try:
        for name, fn in (("series_major", series_major),
                         ("time_major", time_major),
                         ("time_major_contiguous", time_major_contiguous)):
            arima.css_neg_ll_value_and_grad = fn
            st = {}
            m = arima.fit(2, 1, 2, part, method="css-cgd", warn=False,
                          device=dev, stats=st)
            torch.cuda.synchronize()
            runs[name] = (st["bfgs_calls"], m.coefficients.cpu().numpy(),
                          m.diagnostics.n_iter.cpu().numpy())
    finally:
        arima.css_neg_ll_value_and_grad = real

    def agree(a, b):
        xa, xb = runs[a][1], runs[b][1]
        same = (xa == xb) | (np.isnan(xa) & np.isnan(xb))
        return {"x": float(np.mean(same.all(axis=1))),
                "n_iter": float(np.mean(runs[a][2] == runs[b][2]))}

    names = list(runs)
    print(json.dumps({
        "lanes": args.lanes, "calls": {k: v[0] for k, v in runs.items()},
        "normal_equations_calls_parted": len(parted),
        "agree": {f"{a} vs {b}": agree(a, b) for i, a in enumerate(names)
                  for b in names[i + 1:]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
