"""Counts what ``torch.profiler`` receives of one-kernel calls on the card,
fresh and after gaps without a profiler session.

``chip_smoke.py`` counts a call's device operations with the profiler
(``_profile_ops``).  This tool profiles ``reps`` single calls each of
``arma_ne.css_cost`` and ``arma_ne.normal_equations`` at (2,1,2)+c on the
smoke panel's differenced chunk (131072 lanes of 127 steps) and of one
PyTorch elementwise kernel, first right away and then after each of
``--gaps`` seconds with the card idle and no profiler session, and counts
per call the device records the profiler received (kernels) and the
runtime calls that put work on the card (``cudaLaunchKernel`` and the
like, from CUPTI's callbacks on the host).  On a card, from the root of
the repository::

    python3 tools/torch_profiler_records.py [--gaps 45,45] [--reps 12]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
a stage: for each call, the device records and the runtime launches of
each of the ``reps`` profiles.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaps", default="45,45",
                    help="seconds of each idle gap, comma-separated")
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from spark_timeseries_tpu_torch import _build
    from spark_timeseries_tpu_torch.ops import arma_ne

    if not torch.cuda.is_available():
        print("torch_profiler_records: needs a card", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    _build.build_all()
    panel = cs.synthetic_arima_panel(cs.N_SERIES, cs.N_OBS, 0)
    _, (p, q, icpt), y, params, _ = cs.ne_cases(panel, 0)[0]
    y = torch.from_numpy(y).to(dev)
    prm = torch.from_numpy(params).to(dev)
    calls = {"css_cost": lambda: arma_ne.css_cost(prm, y, p, q, icpt),
             "normal_equations": lambda: arma_ne.normal_equations(
                 prm, y, p, q, icpt),
             "torch_mul": lambda: y * 2.0}

    def stage(name, idle_s):
        row = {"stage": name, "idle_s_before": idle_s}
        for key, fn in calls.items():
            got = [cs._profile_ops(fn) for _ in range(args.reps)]
            row[key] = {"device_records": [len(d) for _, d in got],
                        "runtime_launches": [len(r) for r, _ in got]}
        print(json.dumps(row), flush=True)

    stage("fresh", 0.0)
    for i, gap in enumerate(float(g) for g in args.gaps.split(",")):
        torch.cuda.synchronize()
        time.sleep(gap)
        stage(f"after_gap_{i + 1}", gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
