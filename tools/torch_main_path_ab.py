"""Times the PyTorch port's main path in two checkouts on one card.

The main path is ``chip_smoke.py``'s: ``FitEngine().stream_fit`` of its
1,048,576 x 128 ARIMA(2,1,2) panel in 131072-series chunks, with
``collect=True``.  Each run is a process of its own, started from a
checkout's root so that it imports that checkout's package and builds
its kernels there; the runs go A, B, B, A, so drift over the call falls
on both.  Usage, from the root of the repository::

    git archive <commit> | tar -x -C build/parent
    python3 tools/torch_main_path_ab.py build/parent .

Prints one JSON line per run (series/s of each of its ``REPS`` timed
runs after a warm-up, wall seconds, the card's ``nvidia-smi`` name and
power limit) and a last line with the median series/s of each checkout
over all its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPS = 5
RUN = r"""
import json, subprocess, sys, time
import torch
import chip_smoke as cs
from spark_timeseries_tpu_torch import _build
from spark_timeseries_tpu_torch.engine import FitEngine

reps, dev = int(sys.argv[1]), torch.device("cuda", 0)
t0 = time.perf_counter()
_build.build_all()
build_s = time.perf_counter() - t0
torch.backends.cuda.matmul.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60,
                     check=True).stdout.strip().splitlines()[0]
panel = cs.synthetic_arima_panel(cs.N_SERIES, cs.N_OBS, 0)
engine = FitEngine()
engine.stream_fit(panel[:4096], "arima", p=2, d=1, q=2, chunk_size=4096,
                  device=dev)
rates, walls = [], []
for _ in range(reps):
    res = engine.stream_fit(panel, "arima", p=2, d=1, q=2,
                            chunk_size=cs.CHUNK, device=dev, collect=True)
    rates.append(res.rate)
    walls.append(res.wall_s)
print(json.dumps({"series_per_s": rates, "wall_s": walls,
                  "n_converged": res.n_converged, "build_s": build_s,
                  "nvidia_smi": smi}))
"""


def run(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(REPS)],
        cwd=root, env=env, capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"the run in {root} failed:\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="root of the first checkout (the parent)")
    ap.add_argument("b", help="root of the second checkout (the change)")
    args = ap.parse_args(argv)
    rates = {"a": [], "b": []}
    for which in ("a", "b", "b", "a"):
        root = getattr(args, which)
        row = run(root)
        rates[which] += row["series_per_s"]
        print(json.dumps({"checkout": which, "root": root, **row}),
              flush=True)
    print(json.dumps({"median_series_per_s": {
        k: statistics.median(v) for k, v in rates.items()},
        "b_over_a": statistics.median(rates["b"])
        / statistics.median(rates["a"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
