"""The Holt-Winters kernels of this checkout against another checkout's
(its parent, unpacked with ``git archive``) on one card: bits and the
box fit's times.

Each side runs in processes of its own, in the order parent, this, this,
parent (``--turns`` rounds), on the same seeded inputs:

- the time-major ``hw_sse_kernel`` at periods 4, 5, 7, 12, 24 and 52,
  additive and multiplicative, dense and ragged (1000 lanes), and, on
  this side, ``ops.hw_sse.value_and_grad`` on the same inputs, held bit
  for bit against the parent's time-major kernel;
- the box fit (``hw_box_fit_kernel``) of the first Holt-Winters chunk
  (131072 x 120, additive, period 12; CUDA-event times of 3 fits after a
  warm-up) and of two panels at periods outside the kernels' register
  periods (additive 52, multiplicative 5; 16384 lanes), bit for bit:
  x, fun, n_iter and the evaluations.

``tools/torch_kernel_regs.py --sources hw_sse`` compares the two
checkouts' machine code.

On a card, from the root of the repository::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 tools/torch_hw_parent_ab.py --parent build/parent --turns 5

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIT_PERIODS = (4, 5, 7, 12, 24, 52)
BIT_LANES = 1000
BOX_LANES = 16384


def _bit_cases(seed: int):
    """(name, period, model type, series, params, n_valid) of the
    kernels' bitwise cases."""
    import numpy as np

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    rng = np.random.default_rng(seed + 17)
    out = []
    for m in BIT_PERIODS:
        n = max(3 * m + 5, 40)
        for model_type in ("additive", "multiplicative"):
            for ragged in (False, True):
                y = cs.synthetic_hw_panel(BIT_LANES, n, m, seed + m)
                nv = None
                if ragged:
                    nv = rng.integers(2 * m + 1, n + 1, BIT_LANES)
                    y = np.where(np.arange(n)[None, :] < nv[:, None], y,
                                 np.float32(0.0))
                params = rng.uniform(0.05, 0.95, (BIT_LANES, 3)).astype(
                    np.float32)
                out.append((f"{model_type} m={m}" + " ragged" * ragged, m,
                            model_type, y, params, nv))
    return out


def _child(root: str, out: str, seed: int) -> None:
    """In the checkout at ``root``: the bitwise cases and the box fits,
    saved to ``out``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch.ops import hw_sse

    dev = torch.device("cuda", 0)
    time_major = getattr(hw_sse, "_launch_time_major", None) or hw_sse._launch
    saved = {}
    for k, (_, m, model_type, y, params, nv) in enumerate(_bit_cases(seed)):
        y_d = torch.from_numpy(y).to(dev)
        prm = torch.from_numpy(params).to(dev)
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        saved[f"tm{k}"] = time_major(
            prm.T.contiguous(), hw_sse.prepare(y_d, m, model_type, nv_d))
        if hasattr(hw_sse, "_launch_time_major"):
            f, g = hw_sse.value_and_grad(prm, y_d, m, model_type,
                                         n_valid=nv_d)
            saved[f"rows{k}"] = torch.cat([f[None], g.T])
    for name, (S, n, m, model_type) in {
            "m12": (cs.CHUNK, cs.HW_N_OBS, cs.HW_PERIOD, "additive"),
            "m52": (BOX_LANES, 5 * 52, 52, "additive"),
            "m5mul": (BOX_LANES, 60, 5, "multiplicative")}.items():
        panel = cs.synthetic_hw_panel(S, n, m, seed)
        inp = hw_sse.prepare(torch.from_numpy(panel).to(dev), m, model_type)
        x0 = torch.full((S, 3), 0.3, device=dev)
        res, evals = hw_sse.box_fit(inp, x0)
        saved.update({f"{name}_x": res.x, f"{name}_fun": res.fun,
                      f"{name}_n_iter": res.n_iter,
                      f"{name}_evaluations": evals,
                      f"{name}_config": torch.tensor(
                          list(hw_sse.box_fit_config(inp)))})
        if name == "m12":
            saved["box_fit_ms"] = torch.tensor(
                cs._event_times(lambda: hw_sse.box_fit(inp, x0), 3))
    torch.cuda.synchronize()
    arrays = {k: v.cpu().numpy() for k, v in saved.items()}
    np.savez(out, **arrays)


def compare(parent: str, seed: int, out_dir: str, turns: int) -> dict:
    import numpy as np

    order = (parent, HERE, HERE, parent) * turns
    runs = []
    for k, root in enumerate(order):
        out = os.path.join(out_dir, f"run{k}.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child-root", root, "--child-out", out,
                        "--seed", str(seed)], check=True)
        runs.append(dict(np.load(out)))
    old, new = runs[0], runs[1]

    def lanes_apart(a, b, axis=0):
        """The share of lanes (along ``axis``) whose bits differ."""
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        if a.shape != b.shape:
            return 1.0
        ne = np.moveaxis(a.view(np.int32) != b.view(np.int32), axis, 0)
        return float(ne.reshape(ne.shape[0], -1).any(1).mean())

    names = [c[0] for c in _bit_cases(seed)]
    # the kernels' outputs are (4, S), the box fit's (S, ...)
    tm = {n: lanes_apart(old[f"tm{k}"], new[f"tm{k}"], 1)
          for k, n in enumerate(names)}
    rows = {n: lanes_apart(new[f"rows{k}"], old[f"tm{k}"], 1)
            for k, n in enumerate(names)}
    box = {c: {f: lanes_apart(old[f"{c}_{f}"], new[f"{c}_{f}"])
               for f in ("x", "fun", "n_iter", "evaluations")}
           for c in ("m12", "m52", "m5mul")}
    return {
        "phase": "hw_parent_vs_change", "parent": parent, "turns": turns,
        "time_major_lanes_apart": tm,
        "rows_vs_parent_time_major_lanes_apart": rows,
        "box_fit_lanes_apart": box,
        "box_fit_config": {
            "fields": ["threads", "blocks", "smem_bytes", "blocks_per_sm",
                       "sms", "registers", "local_bytes"],
            **{c: {"parent": old[f"{c}_config"].tolist(),
                   "change": new[f"{c}_config"].tolist()}
               for c in ("m12", "m52", "m5mul")}},
        "box_fit_ms": {
            side: [float(v) for root, r in zip(order, runs)
                   if (root == parent) == (side == "parent")
                   for v in r["box_fit_ms"]]
            for side in ("parent", "change")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout to hold this one against")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, this, this, parent")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child-root", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child_root:
        _child(args.child_root, args.child_out, args.seed)
        return 0

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    if not torch.cuda.is_available() or not args.parent:
        print("torch_hw_parent_ab: needs a CUDA card and --parent",
              file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    out_dir = os.path.join(HERE, "build", "hw_parent_ab")
    os.makedirs(out_dir, exist_ok=True)
    print(json.dumps(compare(os.path.abspath(args.parent), args.seed,
                             out_dir, args.turns)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
