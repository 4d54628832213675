"""The port's result NamedTuples against the JAX package's, and the LM
fit's ``grid_orders`` (each candidate of a grid at its own order) on the
CPU: the plain LM that defines it, the auto-fit screen that passes it,
and the CUDA LM-fit kernel's own source compiled for the host (g++, no
FMA contraction, a stub CUDA header), where the launch per candidate at
its own order is held against the padded launch and the plain LM."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as j_engine
from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import autoregression as j_ar
from spark_timeseries_tpu.models import base as j_base
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.ops import linalg as j_linalg
from spark_timeseries_tpu.ops import optimize as j_optimize
from spark_timeseries_tpu.utils import resilience as j_resilience
from spark_timeseries_tpu_torch import _build, engine
from spark_timeseries_tpu_torch.models import (arima, autoregression, base,
                                               convert, holt_winters)
from spark_timeseries_tpu_torch.ops import arma_ne, linalg, optimize
from spark_timeseries_tpu_torch.utils import resilience

RESULT_TUPLES = [
    (arima.PanelARIMAFit, j_arima.PanelARIMAFit),
    (base.FitDiagnostics, j_base.FitDiagnostics),
    (optimize.MinimizeResult, j_optimize.MinimizeResult),
    (arima.ARIMAModel, j_arima.ARIMAModel),
    (autoregression.ARModel, j_ar.ARModel),
    (holt_winters.HoltWintersModel, j_hw.HoltWintersModel),
    (linalg.OLSResult, j_linalg.OLSResult),
    (engine.StreamResult, j_engine.StreamResult),
    (resilience.FitOutcome, j_resilience.FitOutcome),
    (resilience.StageResult, j_resilience.StageResult),
    (resilience.RetryPolicy, j_resilience.RetryPolicy),
    (resilience.FaultSpec, j_resilience.FaultSpec),
]


@pytest.mark.parametrize("port,ref", RESULT_TUPLES,
                         ids=[p.__name__ for p, _ in RESULT_TUPLES])
def test_result_tuples_match_jax(port, ref):
    assert port._fields == ref._fields
    assert port._field_defaults == ref._field_defaults


def _arma(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return y[:, 16:]


def test_auto_fit_panel_unpacks_as_the_jax_package():
    y = np.cumsum(_arma(np.random.default_rng(2), 8, 60), axis=1)
    fit = arima.auto_fit_panel(y, max_p=1, max_q=1, device="cpu")
    orders, coefficients, aic, max_p = fit
    assert orders.shape == (8, 3) and coefficients.shape == (8, 3)
    assert aic.shape == (8,) and max_p == 1
    assert fit.device == torch.device("cpu")
    m = fit.model_for(3)
    p, d, q = orders[3]
    assert (m.p, m.d, m.q) == (p, d, q)
    assert m.coefficients.dtype == torch.float64 \
        and m.coefficients.device.type == "cpu"
    # the copy carries no device: model_for then builds on the default
    again = convert.panel_arima_fit_from_numpy(*fit, device="cpu")
    assert len(again) == 4 and again.device == torch.device("cpu")
    np.testing.assert_array_equal(again.model_for(3).coefficients.numpy(),
                                  m.coefficients.numpy())


def test_panel_arima_fit_copies_keep_their_device():
    fit = convert.panel_arima_fit_from_numpy(
        np.array([[1, 1, 1], [2, 2, 0]]),
        np.array([[0.5, 0.3, 0.0, 0.2], [0.0, 0.1, -0.2, 0.0]]),
        np.array([10.0, 12.0]), 2, device="cpu")
    # _replace carries the device over; _make has no fit to take it from
    moved = fit._replace(aic=fit.aic + 1.0)
    assert moved.device == torch.device("cpu") and len(moved) == 4
    m = moved.model_for(0)
    assert (m.p, m.d, m.q) == (1, 1, 1) and m.coefficients.dtype \
        == torch.float64 and m.coefficients.device.type == "cpu"
    np.testing.assert_array_equal(m.coefficients.numpy(), [0.5, 0.3, 0.2])
    made = arima.PanelARIMAFit._make(fit)
    assert made.device == torch.device("cuda")
    made.device = torch.device("cpu")
    m = made.model_for(1)
    assert (m.p, m.d, m.q) == (2, 2, 0) and m.coefficients.device.type \
        == "cpu"
    np.testing.assert_array_equal(m.coefficients.numpy(), [0.1, -0.2])


def _grid(rng, P, Q, icpt, S_y, n, ragged):
    """A candidate-major grid over the padded ARMA(P, Q) layout: every
    candidate order (p, q) <= (P, Q) but the empty one, x0 (C·S_y, k), a
    mask with a per-lane intercept zeroed (a series whose d > 1)."""
    orders = [(a, b) for a in range(P + 1) for b in range(Q + 1)
              if icpt + a + b]
    C, k = len(orders), icpt + P + Q
    y = _arma(rng, S_y, n)
    nv = None
    if ragged:
        nv = rng.integers(n // 2, n + 1, size=S_y)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv)
    x0 = 0.1 * rng.normal(size=(C * S_y, k))
    mask = np.ones((C * S_y, k))
    if icpt:
        mask[rng.uniform(size=C * S_y) < 0.3, 0] = 0.0
    return (orders, torch.from_numpy(x0), torch.from_numpy(y),
            torch.from_numpy(mask), nv)


def _own(orders, S_y, P, Q, icpt):
    return arma_ne._order_mask(orders, len(orders) * S_y, S_y, P, Q, icpt,
                               torch.float64, "cpu")


@pytest.mark.parametrize("ragged", [False, True])
def test_grid_orders_equal_a_mask_that_respects_them(ragged):
    rng = np.random.default_rng(11)
    orders, x0, y, mask, nv = _grid(rng, 2, 2, 1, 12, 50, ragged)
    own_mask = mask * _own(orders, 12, 2, 2, 1)
    kw = dict(max_iter=20, n_valid=nv)
    want = arma_ne.fit_css_lm_plain(x0, y, 2, 2, 1, mask=own_mask, **kw)
    for fit in (arma_ne.fit_css_lm_plain, arma_ne.fit_css_lm,
                arma_ne.fit_css_lm_route):
        got = fit(x0, y, 2, 2, 1, mask=own_mask, grid_orders=orders, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert bool(torch.isfinite(want[1]).all())


def test_grid_orders_zero_the_slots_outside_each_order():
    rng = np.random.default_rng(12)
    orders, x0, y, _, _ = _grid(rng, 2, 1, 0, 10, 40, False)
    own = _own(orders, 10, 2, 1, 0)
    assert (own.sum(dim=1).view(len(orders), 10)[:, 0]
            == torch.tensor([p + q for p, q in orders],
                            dtype=own.dtype)).all()
    got = arma_ne.fit_css_lm_plain(x0, y, 2, 1, 0, max_iter=15,
                                   grid_orders=orders)
    assert bool((got[0][own == 0] == 0).all())
    assert bool((got[0][own == 1] != 0).all())
    # the same as the mask of each candidate's order, and unlike no mask
    want = arma_ne.fit_css_lm_plain(x0, y, 2, 1, 0, max_iter=15, mask=own)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    free = arma_ne.fit_css_lm_plain(x0, y, 2, 1, 0, max_iter=15)
    assert not torch.equal(got[1], free[1])


def test_grid_orders_rejects():
    rng = np.random.default_rng(13)
    orders, x0, y, mask, _ = _grid(rng, 2, 2, 1, 6, 30, False)
    before = arma_ne.fit_css_lm.launches
    with pytest.raises(ValueError, match="grid_orders has 8 candidates"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, grid_orders=orders[:-1])
    with pytest.raises(ValueError, match="does not fit"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, grid_orders=[(3, 0)] * 9)
    with pytest.raises(ValueError, match="no parameter"):
        arma_ne.fit_css_lm(x0[:, 1:], y, 2, 2, 0, grid_orders=[(0, 0)] * 9)
    with pytest.raises(ValueError, match="not a multiple"):
        arma_ne.fit_css_lm(x0[:-1], y, 2, 2, 1, grid_orders=orders)
    assert arma_ne.fit_css_lm.launches == before


def test_auto_fit_panel_screen_passes_its_orders(monkeypatch):
    y = _arma(np.random.default_rng(14), 12, 60)
    seen = []
    real = arima.fit_css_lm

    def spy(x0, yy, *args, **kw):
        seen.append((x0.shape[0], kw.get("grid_orders")))
        return real(x0, yy, *args, **kw)
    monkeypatch.setattr(arima, "fit_css_lm", spy)
    stats = {}
    arima.auto_fit_panel(y, max_p=1, max_q=2, max_iter=10,
                         screen_max_iter=4, device="cpu", stats=stats)
    pq = [(p, q) for p in range(2) for q in range(3)]
    # the screen runs each candidate at its order; the refine's winners
    # are of mixed orders, so it runs padded
    assert seen == [(6 * 12, pq), (12, None)]
    assert stats["lm_fit_launches"] == 0       # no kernel on the CPU


# ---------------------------------------------------------------------------
# the LM-fit kernel's source on the host

_STUB = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 blockIdx, threadIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
// unfused, as the plain loop rounds each product: the check holds the
// kernel's order of operations, and a padded slot's zero terms are exact
// either way
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
using std::isfinite;
using std::isnan;
inline float fabsf(float a) { return std::fabs(a); }
"""

# Runs arma_lm_fit_kernel thread by thread: the padded launch over every
# lane of the grid, then one launch per candidate at its own order into
# x0 * mask; writes both results.
_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "arma_ne_host.cuh"
dim3 blockIdx, threadIdx, blockDim;
using namespace arma_ne;

template <int P, int Q>
LmKernel pick2(bool r) {
  return r ? &arma_lm_fit_kernel<P, Q, 1, true>
           : &arma_lm_fit_kernel<P, Q, 1, false>;
}
LmKernel pick(int p, int q, bool r) {
#define X(PP, QQ) if (p == PP && q == QQ) return pick2<PP, QQ>(r);
  X(0, 0) X(0, 1) X(0, 2) X(1, 0) X(1, 1) X(1, 2) X(2, 0) X(2, 1) X(2, 2)
#undef X
  return nullptr;
}
void run(LmKernel k, LmArgs A) {
  blockDim = dim3(128);
  for (int r = 0; r < A.S; ++r) {
    blockIdx = dim3(r / 128);
    threadIdx = dim3(r % 128);
    k(A);
  }
}
template <class T> void rd(FILE* f, std::vector<T>& v) {
  if (fread(v.data(), sizeof(T), v.size(), f) != v.size()) throw 1;
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<int> h(7);
  rd(f, h);
  const int P = h[0], Q = h[1], S_y = h[2], C = h[3], n = h[4];
  const bool ragged = h[5];
  const int k = 1 + P + Q, S = C * S_y, t0 = P > Q ? P : Q;
  std::vector<float> x0(k * S), y(n * S_y), nv(S_y), mask(k * S);
  std::vector<int> ord(2 * C);
  rd(f, x0); rd(f, y); rd(f, nv); rd(f, mask); rd(f, ord);
  fclose(f);
  std::vector<float> x(2 * k * S), fun(2 * S);
  std::vector<unsigned char> conv(2 * S);
  std::vector<int> it(2 * S);
  const float* nvp = ragged ? nv.data() : nullptr;
  run(pick(P, Q, ragged),
      LmArgs{x0.data(), y.data(), nvp, mask.data(), x.data(), fun.data(),
             conv.data(), it.data(), S, S_y, n, 1e-6f, h[6], 0, S, 1 + P,
             t0});
  for (int i = 0; i < k * S; ++i) x[k * S + i] = x0[i] * mask[i];
  for (int c = 0; c < C; ++c)
    run(pick(ord[2 * c], ord[2 * c + 1], ragged),
        LmArgs{x0.data(), y.data(), nvp, mask.data(), x.data() + k * S,
               fun.data() + S, conv.data() + S, it.data() + S, S_y, S_y, n,
               1e-6f, h[6], c * S_y, S, 1 + P, t0});
  FILE* o = fopen(argv[2], "wb");
  fwrite(x.data(), 4, x.size(), o);
  fwrite(fun.data(), 4, fun.size(), o);
  fwrite(conv.data(), 1, conv.size(), o);
  fwrite(it.data(), 4, it.size(), o);
  fclose(o);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's source for the host")
    d = tmp_path_factory.mktemp("lm_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    # a host compiler reads the launch syntax of the header's launch_ne
    # as an error: the launches are dropped, the kernels stay
    src = (_build.CSRC / "arma_ne.cuh").read_text()
    (d / "arma_ne_host.cuh").write_text(re.sub(r"<<<[^>]*>>>", "", src))
    (d / "harness.cpp").write_text(_HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O0", "-ffp-contract=off",
                    f"-I{d}", "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True)
    return d


def _host_fit(d, orders, x0, y, mask, nv, max_iter):
    P = max(p for p, _ in orders)
    Q = max(q for _, q in orders)
    S_y, n = y.shape
    C, k = len(orders), 1 + P + Q
    S = C * S_y
    f32 = np.float32
    with open(d / "in.bin", "wb") as f:
        np.array([P, Q, S_y, C, n, nv is not None, max_iter],
                 np.int32).tofile(f)
        np.ascontiguousarray(x0.numpy().T, f32).tofile(f)
        np.ascontiguousarray(y.numpy().T, f32).tofile(f)
        (np.zeros(S_y, f32) if nv is None else nv.numpy().astype(f32)) \
            .tofile(f)
        np.ascontiguousarray(mask.numpy().T, f32).tofile(f)
        np.array(orders, np.int32).tofile(f)
    subprocess.run([str(d / "harness"), str(d / "in.bin"),
                    str(d / "out.bin")], check=True)
    raw = np.fromfile(d / "out.bin", np.uint8)
    xs = raw[:8 * k * S].view(f32).reshape(2, k, S)
    fun = raw[8 * k * S:8 * k * S + 8 * S].view(f32).reshape(2, S)
    conv = raw[8 * k * S + 8 * S:8 * k * S + 10 * S].reshape(2, S)
    it = raw[8 * k * S + 10 * S:].view(np.int32).reshape(2, S)
    return [tuple(torch.from_numpy(a[i].copy()) for a in
                  (xs.transpose(0, 2, 1), fun, conv.astype(bool), it))
            for i in range(2)]


def _sqrt_rounded(s):
    # the card's __fsqrt_rn rounds correctly; the CPU's float32 torch.sqrt
    # may not, so the plain LM takes the root in float64, then rounds once
    # (exact for a float32 argument)
    return _real_sqrt(s.double()).to(s.dtype)


_real_sqrt = torch.sqrt


@pytest.mark.parametrize("ragged", [False, True])
def test_lm_kernel_per_candidate_equals_padded_on_the_host(
        host_kernel, ragged, monkeypatch):
    rng = np.random.default_rng(15 + ragged)
    orders, x0, y, mask, nv = _grid(rng, 2, 2, 1, 40, 70, ragged)
    x0, y, mask = x0.float(), y.float(), mask.float()
    padded, per_candidate = _host_fit(host_kernel, orders, x0, y,
                                      mask * _own(orders, 40, 2, 2, 1)
                                      .float(), nv, 25)
    # the slots a candidate owns, fun, converged and n_iter: the same
    # values (a zero's sign may differ in the slots it does not own)
    for a, b in zip(per_candidate, padded):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(padded[1]).all())
    # and the plain LM that defines grid_orders, bit for bit
    monkeypatch.setattr(torch, "sqrt", _sqrt_rounded)
    plain = arma_ne.fit_css_lm_plain(x0, y, 2, 2, 1, max_iter=25, mask=mask,
                                     n_valid=nv, grid_orders=orders)
    for a, b in zip(per_candidate, plain):
        assert torch.equal(a, b)
