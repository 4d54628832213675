#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spark_timeseries_tpu_torch``) on one
NVIDIA card and hold its CUDA kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. ``device``: the card (with ``nvidia-smi``'s name and power limit on a
   line of its own), torch and CUDA versions; TF32 matmuls off.
2. ``build``: nvcc builds every kernel from ``csrc/``.
3. ``kernel_vs_plain``: ``ops.arma_ne.normal_equations`` (the CUDA kernel)
   against ``normal_equations_plain`` in float32 on the card and in
   float64 on the CPU, at the main path's chunk shape.
4. ``main_path``: ``FitEngine().stream_fit`` of a 1,048,576 x 128
   float32 ARIMA(2,1,2) panel in 131072-series chunks on the card, the
   kernel's launches counted over exactly that run; then 4096 of its lanes
   refitted on the CPU in float64 and compared.
5. ``timing``: CUDA-event times of the kernel and of its plain version,
   the kernel's bound, and one LM iteration split into kernel and rest.

Then one line of per-kernel numbers and, last, the result line.  Any
failed check raises, so the script exits non-zero and prints no result
line; without CUDA it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_SERIES = 1_048_576     # the bench's north-star panel
N_OBS = 128
CHUNK = 131072           # series per chunk, as the JAX bench streams them
N_REFIT = 4096           # lanes refitted on the CPU in float64

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# kernel vs plain: normalized errors (see _ne_errors).  float32 sums over
# <= 127 steps carry a relative rounding of ~127 * 6e-8 = 8e-6 at worst
# per accumulator; the kernel contracts a*b+c into FMAs where the plain
# loop rounds twice, so neither side is exact and 1e-4 bounds both
NE_TOL = 1e-4

# f32-on-card vs f64-on-CPU fits: the float32 LM stops at a relative SSE
# drop of 1e-6 (float64 at 1e-10), so along the CSS surface's flat
# common-factor directions float32 coefficients sit ~1e-3 from the
# float64 optimum (the JAX package's two float32 LM solvers differ by a
# median 8e-4 in tests/test_pallas_arma.py, Pallas against XLA).
# A wrong kernel or solver moves lanes by far more, so: at least 40% of
# lanes converged in both agree to 1e-3 and at least 90% to 5e-3.
AGREE = ((1e-3, 0.40), (5e-3, 0.90))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def synthetic_arima_panel(n_series: int, n_obs: int,
                          seed: int = 0) -> np.ndarray:
    """ARIMA(2,1,2) draws: ARMA(2,2) innovations then one integration
    (the panel of the JAX package's ``bench.py``)."""
    rng = np.random.default_rng(seed)
    phi = np.stack([rng.uniform(0.1, 0.3, n_series),
                    rng.uniform(0.2, 0.5, n_series)], axis=1)
    theta = np.stack([rng.uniform(0.1, 0.4, n_series),
                      rng.uniform(0.0, 0.2, n_series)], axis=1)
    eps = rng.normal(size=(n_series, n_obs + 2)).astype(np.float32)
    y = np.zeros((n_series, n_obs), dtype=np.float32)
    for t in range(n_obs):
        ar = 0.0
        if t >= 1:
            ar = phi[:, 0] * y[:, t - 1]
        if t >= 2:
            ar = ar + phi[:, 1] * y[:, t - 2]
        ma = theta[:, 0] * eps[:, t + 1] + theta[:, 1] * eps[:, t]
        y[:, t] = 1.0 + ar + ma + eps[:, t + 2]
    return np.cumsum(y, axis=1)


def ne_flops_per_step(p: int, q: int, icpt: int, ragged: bool) -> int:
    """Floating-point operations of one lane-step of the ARMA kernel:
    yhat (2 per AR and MA term), e (1), T (2 per MA term per column, plus
    the negation), the ragged weights, sse (2), triu (2 each), Jtr (2
    each)."""
    k = icpt + p + q
    n_tri = k * (k + 1) // 2
    return 2 * (p + q) + 1 + k * (2 * q + 1) + (k + 1 if ragged else 0) \
        + 2 + 2 * n_tri + 2 * k


def ne_bound_s(S: int, n_obs: int, p: int, q: int, icpt: int,
               ragged: bool):
    """Least time of one kernel call on the card: bytes it must move
    (y, params, n_valid read once, the packed output written once) over
    the HBM rate, and its FLOPs over the fp32 rate; the larger wins."""
    k = icpt + p + q
    n_out = 1 + k * (k + 1) // 2 + k
    n_bytes = 4 * S * (n_obs + k + n_out + (1 if ragged else 0))
    flops = ne_flops_per_step(p, q, icpt, ragged) * (n_obs - max(p, q)) * S
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes, flops


def _ne_errors(got, ref):
    """Normalized errors of ``(JᵀJ, Jᵀr, sse)`` against a reference:
    sse relative to itself, each JᵀJ entry to sqrt(JᵀJ_aa JᵀJ_bb), each
    Jᵀr entry to sqrt(JᵀJ_aa sse) — the Cauchy-Schwarz bounds of the
    entries, so near-zero entries are judged on their lane's scale."""
    import torch

    jtj, jtr, sse = (t.double().cpu() for t in got)
    jtj_r, jtr_r, sse_r = (t.double().cpu() for t in ref)
    diag = torch.diagonal(jtj_r, dim1=-2, dim2=-1)
    return {
        "sse": ((sse - sse_r).abs() / sse_r.abs()).max().item(),
        "jtj": ((jtj - jtj_r).abs() / torch.sqrt(
            diag[:, :, None] * diag[:, None, :])).max().item(),
        "jtr": ((jtr - jtr_r).abs() / torch.sqrt(
            diag * sse_r[:, None])).max().item(),
    }


def ne_cases(panel: np.ndarray, seed: int):
    """The kernel's test cases at the main path's chunk shape: name,
    (p, q, icpt), series, params, n_valid."""
    rng = np.random.default_rng(seed + 1)
    chunk = panel[:CHUNK]
    diffed = np.ascontiguousarray(np.diff(chunk, axis=1))    # n_obs - 1
    S = chunk.shape[0]
    nv = rng.integers(40, diffed.shape[1] + 1, S).astype(np.float32)
    cases = []
    for name, (p, q, icpt), y, ragged in (
            ("arima(2,1,2)+c", (2, 2, 1), diffed, False),
            ("arima(2,1,2)+c ragged", (2, 2, 1), diffed, True),
            ("arima(1,0,0)", (1, 0, 0), chunk, False),
            ("arima(3,0,2)+c", (3, 2, 1), chunk, False)):
        k = icpt + p + q
        params = (0.1 * rng.normal(size=(S, k))).astype(np.float32)
        cases.append((name, (p, q, icpt), y, params,
                      nv if ragged else None))
    return cases


def phase_kernel_vs_plain(panel, seed, dev):
    import torch

    from spark_timeseries_tpu_torch.ops import arma_ne

    rows, max_abs = [], 0.0
    for name, (p, q, icpt), y, params, nv in ne_cases(panel, seed):
        y_d = torch.from_numpy(y).to(dev)
        prm_d = torch.from_numpy(params).to(dev)
        nv_d = None if nv is None else torch.from_numpy(nv).to(dev)
        got = arma_ne.normal_equations(prm_d, y_d, p, q, icpt, n_valid=nv_d)
        plain = arma_ne.normal_equations_plain(prm_d, y_d, p, q, icpt,
                                               n_valid=nv_d)
        ref64 = arma_ne.normal_equations_plain(
            torch.from_numpy(params).double(), torch.from_numpy(y).double(),
            p, q, icpt,
            n_valid=None if nv is None else torch.from_numpy(nv).double())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        vs_plain = _ne_errors(got, plain)
        vs_f64 = _ne_errors(got, ref64)
        if name == "arima(2,1,2)+c":
            max_abs = max((a - b).abs().max().item()
                          for a, b in zip(got, plain))
        row = {"case": name, "S": y.shape[0], "n_obs": y.shape[1],
               "vs_plain_f32": vs_plain, "vs_plain_f64_cpu": vs_f64,
               "tol": NE_TOL}
        rows.append(row)
        for label, errs in (("plain f32", vs_plain), ("plain f64", vs_f64)):
            for key, err in errs.items():
                check(err <= NE_TOL,
                      f"{name}: kernel vs {label} {key} error {err:.3g} > "
                      f"{NE_TOL:g}")
    return rows, max_abs


def phase_main_path(panel, dev, n_refit=N_REFIT, chunk=CHUNK):
    import torch

    from spark_timeseries_tpu_torch.engine import FitEngine
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    engine = FitEngine()
    # warm-up: library load, CUDA/cuBLAS handles (not counted)
    engine.stream_fit(panel[:4096], "arima", p=2, d=1, q=2,
                      chunk_size=4096, device=dev)
    arma_ne.normal_equations.launches = 0
    res = engine.stream_fit(panel, "arima", p=2, d=1, q=2,
                            chunk_size=chunk, device=dev, collect=True)
    launches = arma_ne.normal_equations.launches
    iters = res.stats["lm_iterations"]
    check(not res.chunk_failures,
          f"chunk failures: {[f['error'] for f in res.chunk_failures]}")
    check(launches > 0, "the main path never launched the ARMA kernel")
    check(launches == sum(i + 1 for i in iters),
          f"kernel launches {launches} != sum of (LM iterations + 1) "
          f"{sum(i + 1 for i in iters)}")
    coefs = torch.cat([m.coefficients for m in res.models]).numpy()
    conv = torch.cat([m.diagnostics.converged for m in res.models]).numpy()
    check(coefs.shape == (panel.shape[0], 5), f"coefficients {coefs.shape}")
    check(bool(np.isfinite(coefs[conv]).all()),
          "non-finite coefficients on converged lanes")
    converged_pct = 100.0 * res.n_converged / res.n_series
    check(converged_pct >= 50.0, f"converged_pct {converged_pct:.2f} < 50")

    t0 = time.perf_counter()
    ref = arima.fit(2, 1, 2, panel[:n_refit].astype(np.float64),
                    warn=False, device="cpu")
    refit_s = time.perf_counter() - t0
    both = conv[:n_refit] & ref.diagnostics.converged.numpy()
    dx = np.abs(coefs[:n_refit].astype(np.float64)
                - ref.coefficients.numpy()).max(axis=1)[both]
    agree = {f"{tol:g}": float(np.mean(dx <= tol)) for tol, _ in AGREE}
    for tol, floor in AGREE:
        check(agree[f"{tol:g}"] >= floor,
              f"only {agree[f'{tol:g}']:.3f} of lanes agree with the f64 "
              f"CPU refit to {tol:g} (floor {floor})")
    return {"phase": "main_path", "n_series": res.n_series,
            "n_obs": panel.shape[1], "chunk_size": chunk,
            "n_chunks": res.n_chunks, "wall_s": res.wall_s,
            "series_per_s": res.rate, "converged_pct": converged_pct,
            "lm_iterations_per_chunk": iters,
            "normal_equations_launches": launches,
            "refit_lanes": n_refit, "refit_cpu_f64_s": refit_s,
            "refit_both_converged": float(np.mean(both)),
            "refit_agree_share": agree,
            "refit_agree_floor": {f"{t:g}": f for t, f in AGREE},
            "refit_median_abs_diff": float(np.median(dx))}, launches


def _event_ms(fn, reps: int):
    """Median CUDA-event time of ``fn()`` over ``reps`` calls, after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(panel, seed, dev):
    import torch

    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import arma_ne

    name, (p, q, icpt), y, params, _ = ne_cases(panel, seed)[0]
    y_d = torch.from_numpy(y).to(dev)
    prm_d = torch.from_numpy(params).to(dev)
    S, n_obs = y.shape
    y_t, prm_t = y_d.T.contiguous(), prm_d.T.contiguous()
    kernel_ms = _event_ms(
        lambda: arma_ne._launch(prm_t, y_t, None, p, q, icpt), 20)
    plain_ms = _event_ms(
        lambda: arma_ne._packed_plain(prm_t, y_t, None, p, q, icpt), 3)
    bound_s, bound_by, n_bytes, flops = ne_bound_s(S, n_obs, p, q, icpt,
                                                   False)

    # one LM fit of the chunk from its Hannan-Rissanen init
    init = arima.hannan_rissanen_init(p, q, y_d, True)
    torch.cuda.synchronize()
    launches0 = arma_ne.normal_equations.launches
    t0 = time.perf_counter()
    _, _, _, it_lanes = arma_ne.fit_css_lm(init, y_d, p, q, icpt)
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    n_launch = arma_ne.normal_equations.launches - launches0
    iterations = int(it_lanes.max())
    per_iter_ms = lm_s * 1e3 / max(iterations, 1)
    kernel_per_iter_ms = kernel_ms * n_launch / max(iterations, 1)
    return {"phase": "timing", "case": name, "S": S, "n_obs": n_obs,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_us": bound_s * 1e6, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
            "kernel_share_of_bound": bound_s * 1e3 / kernel_ms,
            "lm_iterations": iterations, "lm_kernel_launches": n_launch,
            "lm_fit_ms": lm_s * 1e3,
            "lm_iteration_ms": per_iter_ms,
            "lm_iteration_kernel_ms": kernel_per_iter_ms,
            "lm_iteration_rest_ms": per_iter_ms - kernel_per_iter_ms}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic panel and kernel inputs")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "card", file=sys.stderr)
        return 1
    from spark_timeseries_tpu_torch import _build
    from spark_timeseries_tpu_torch.ops import arma_ne

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    libs = _build.build_all()
    arma_ne._kernel_fn()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.name) for p in libs]})

    t0 = time.perf_counter()
    panel = synthetic_arima_panel(N_SERIES, N_OBS, args.seed)
    emit({"phase": "panel", "shape": list(panel.shape),
          "dtype": str(panel.dtype), "seconds": time.perf_counter() - t0})

    rows, max_abs = phase_kernel_vs_plain(panel, args.seed, dev)
    emit({"phase": "kernel_vs_plain", "cases": rows})

    main_row, launches = phase_main_path(panel, dev)
    emit(main_row)

    timing = phase_timing(panel, args.seed, dev)
    emit(timing)

    emit({"kernels": [{
        "name": "arma_ne", "route": "cuda",
        "source": "spark_timeseries_tpu_torch/csrc/arma_ne.cu",
        "replaces": "spark_timeseries_tpu/ops/pallas_arma.py:229",
        "launches": launches, "max_abs_err": max_abs,
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_us"] / 1e3,
        "bound_by": timing["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
