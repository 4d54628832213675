"""Classifies the lanes where the batched BFGS over the ``arma_ne`` kernel
and the same BFGS over its plain pass end apart, on one card.

The inputs are those of ``tests/test_torch_cuda.py::
test_css_cgd_counts_one_arma_ne_launch_per_evaluation``: 512 cumulated
ARMA(2,2) series of 96 steps from ``np.random.default_rng(seed)``
(seed 31 there), float32, differenced once, the Hannan-Rissanen start,
``minimize_bfgs`` with its defaults over
``css_neg_ll_value_and_grad`` (the kernel) and over
``css_neg_ll_value_and_grad_plain``.  Every value-and-gradient call of
both runs is recorded per lane.  A lane misses when its two ``fun`` are
not within 1e-5 relative; each miss is one of

- ``nan_both``: ``fun`` NaN in both runs (with whether the start's
  value was NaN in both);
- ``nonfinite_other``: not finite in a run, and not NaN in both (an
  inf ``fun``, or NaN in one run only);
- ``finite_part``: both finite and apart.

For a ``finite_part`` lane the script finds the first call at which the
two runs' trial points part by more than 1e-3 of the point's largest
entry, and re-evaluates every trial point of the kernel run before it
with the kernel, the plain pass in float32 and the plain pass in
float64: the largest error of the kernel's value and gradient and of the
plain pass's, each against float64, say whether the kernel computes
beyond float32 rounding.  Usage, from the root of the repository::

    python3 tools/torch_cgd_miss_trace.py [--seeds 31 32 33] [--device cuda]
        [--out records.json]

Prints one JSON line per seed; ``--out`` also writes the per-lane
records there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spark_timeseries_tpu_torch.models import arima  # noqa: E402
from spark_timeseries_tpu_torch.ops import arma_ne, optimize  # noqa: E402
from spark_timeseries_tpu_torch.ops.univariate import (  # noqa: E402
    differences_of_order_d)

RTOL = 1e-5
PART = 1e-3


def _panel(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return y[:, 16:]


def _bfgs(fn, diffed, x0):
    """``minimize_bfgs`` over ``fn`` with every call logged as ``(lanes,
    x, f, g)`` on the host."""
    S = x0.shape[0]
    log = []

    def ev_for(idx):
        yy = diffed if idx is None else diffed.index_select(0, idx)
        lanes = np.arange(S) if idx is None else idx.cpu().numpy()

        def ev(x):
            f, g = fn(x, yy, 2, 2, 1)
            log.append((lanes, x.detach().cpu().numpy(),
                        f.detach().cpu().numpy(), g.detach().cpu().numpy()))
            return f, g
        return ev

    res = optimize.minimize_bfgs(ev_for(None), x0, evaluator_for=ev_for)
    return res, log


def _per_lane(log, S):
    """Per lane, the list of ``(x, f, g)`` of its calls in order."""
    out = [[] for _ in range(S)]
    for lanes, x, f, g in log:
        for j, lane in enumerate(lanes):
            out[lane].append((x[j], f[j], g[j]))
    return out


def _rel_err(got, ref):
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True)
                       if ref.ndim > 1 else np.abs(ref), 1e-30)
    err = np.abs(got - ref)
    if ref.ndim > 1:
        err = err.max(axis=-1, keepdims=True)
    return (err / scale).reshape(-1)


def run_seed(seed: int, dev: torch.device, S: int = 512, n: int = 96):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(np.cumsum(_panel(rng, S, n), axis=1)
                         .astype(np.float32)).to(dev)
    diffed = differences_of_order_d(y, 1)[..., 1:]
    x0 = arima.hannan_rissanen_init(2, 2, diffed, True)
    kern, klog = _bfgs(arma_ne.css_neg_ll_value_and_grad, diffed, x0)
    plain, plog = _bfgs(arma_ne.css_neg_ll_value_and_grad_plain, diffed, x0)
    kf = kern.fun.double().cpu().numpy()
    pf = plain.fun.double().cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(kf - pf) / np.abs(pf)
    agree = rel <= RTOL
    kl, pl = _per_lane(klog, S), _per_lane(plog, S)
    nan_k, nan_p = np.isnan(kf), np.isnan(pf)
    start_nan = np.array([np.isnan(kl[i][0][1]) and np.isnan(pl[i][0][1])
                          for i in range(S)])
    both_fin = np.isfinite(kf) & np.isfinite(pf)
    nan_both = nan_k & nan_p
    nonfinite_other = ~both_fin & ~nan_both
    finite_part = both_fin & ~agree
    records = []
    # every kernel-run trial point of each parting lane before it parts
    pts, rows, owner = [], [], []
    for lane in np.flatnonzero(finite_part):
        a, b = kl[lane], pl[lane]
        first_diff = part = None
        for j in range(min(len(a), len(b))):
            dx = np.abs(a[j][0] - b[j][0]).max()
            if first_diff is None and dx > 0:
                first_diff = j
            if dx > PART * max(np.abs(b[j][0]).max(), 1e-30):
                part = j
                break
        stop = part if part is not None else min(len(a), len(b))
        for j in range(stop):
            pts.append(a[j][0])
            rows.append(lane)
            owner.append(len(records))
        records.append({
            "lane": int(lane), "fun_kernel": float(kf[lane]),
            "fun_plain": float(pf[lane]), "rel": float(rel[lane]),
            "calls_kernel": len(a), "calls_plain": len(b),
            "n_iter_kernel": int(kern.n_iter[lane]),
            "n_iter_plain": int(plain.n_iter[lane]),
            "converged_kernel": bool(kern.converged[lane]),
            "converged_plain": bool(plain.converged[lane]),
            "first_call_x_differs": first_diff,
            "first_call_x_parts": part,
            "x_at_part_kernel": None if part is None
            else a[part][0].tolist(),
            "x_at_part_plain": None if part is None
            else b[part][0].tolist()})
    if pts:
        x = torch.from_numpy(np.stack(pts)).to(dev)
        idx = torch.from_numpy(np.asarray(rows)).to(dev)
        yy = diffed.index_select(0, idx)
        fk, gk = arma_ne.css_neg_ll_value_and_grad(x, yy, 2, 2, 1)
        fp, gp = arma_ne.css_neg_ll_value_and_grad_plain(x, yy, 2, 2, 1)
        f64, g64 = arma_ne.css_neg_ll_value_and_grad_plain(
            x.double(), yy.double(), 2, 2, 1)
        f64, g64 = f64.cpu().numpy(), g64.cpu().numpy()
        ek_f = _rel_err(fk.double().cpu().numpy(), f64)
        ep_f = _rel_err(fp.double().cpu().numpy(), f64)
        ek_g = _rel_err(gk.double().cpu().numpy(), g64)
        ep_g = _rel_err(gp.double().cpu().numpy(), g64)
        owner = np.asarray(owner)
        for r, rec in enumerate(records):
            m = owner == r
            if not m.any():
                continue
            fin = m & np.isfinite(f64)
            rec["trial_points_checked"] = int(m.sum())
            for name, e in (("kernel_f", ek_f), ("plain_f", ep_f),
                            ("kernel_g", ek_g), ("plain_g", ep_g)):
                rec[f"max_rel_err_{name}"] = float(np.nanmax(e[fin])) \
                    if fin.any() else None
    summary = {
        "seed": seed, "lanes": S, "agree_share_old_rule": float(
            np.mean(agree)),
        "misses": int((~agree).sum()), "nan_both": int(nan_both.sum()),
        "nan_both_from_nan_start": int((nan_both & start_nan).sum()),
        "nonfinite_other": int(nonfinite_other.sum()),
        "finite_part": int(finite_part.sum()),
        "finite_lanes": int(both_fin.sum()),
        "finite_share": float(np.mean(agree[both_fin]))
        if both_fin.any() else None,
        "share_nan_both_counted": float(np.mean(agree | nan_both)),
        "kernel_calls": len(klog), "plain_calls": len(plog)}
    checked = [r for r in records if r.get("trial_points_checked")]
    if checked:
        for name in ("kernel_f", "plain_f", "kernel_g", "plain_g"):
            vals = [r[f"max_rel_err_{name}"] for r in checked
                    if r[f"max_rel_err_{name}"] is not None]
            summary[f"max_rel_err_{name}"] = max(vals) if vals else None
        summary["parted_lanes"] = sum(r["first_call_x_parts"] is not None
                                      for r in records)
    return summary, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[31])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="JSON file for the per-lane records")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    out = {}
    for seed in args.seeds:
        summary, records = run_seed(seed, dev)
        print(json.dumps(summary), flush=True)
        out[seed] = {"summary": summary, "lanes": records}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
