"""The PyTorch port's ops against their JAX twins, on the CPU.

Inputs come from numpy and go to both packages; JAX runs with x64
(``tests/conftest.py``) and the port in float64, so the algorithms are
compared at float64.
"""

import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import base as jbase
from spark_timeseries_tpu.ops import lag as jlag
from spark_timeseries_tpu.ops import linalg as jlinalg
from spark_timeseries_tpu.ops import optimize as jopt
from spark_timeseries_tpu.ops import ragged as jragged
from spark_timeseries_tpu.ops import univariate as juni
from spark_timeseries_tpu_torch.models import base
from spark_timeseries_tpu_torch.ops import lag, linalg, ragged, univariate
from spark_timeseries_tpu_torch.ops.optimize import MinimizeResult

torch.set_num_threads(1)

# identical float64 arithmetic up to summation order
RTOL = 1e-12


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("max_lag,include_original", [(1, False), (3, False),
                                                      (2, True)])
def test_lag_ops_match_jax(max_lag, include_original):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 40))
    coef = rng.normal(size=(6, max_lag))
    np.testing.assert_allclose(
        _np(lag.lag_stack(torch.from_numpy(x), max_lag, include_original)),
        _np(jlag.lag_stack(jnp.asarray(x), max_lag, include_original)),
        rtol=RTOL)
    np.testing.assert_allclose(
        _np(lag.lag_matrix(torch.from_numpy(x), max_lag, include_original)),
        _np(jlag.lag_matrix(jnp.asarray(x), max_lag, include_original)),
        rtol=RTOL)
    np.testing.assert_allclose(
        _np(lag.lag_matvec(torch.from_numpy(x), torch.from_numpy(coef),
                           max_lag)),
        _np(jlag.lag_matvec(jnp.asarray(x), jnp.asarray(coef), max_lag)),
        rtol=RTOL)
    with pytest.raises(ValueError):
        lag.lag_stack(torch.from_numpy(x), 40)


@pytest.mark.parametrize("d", [0, 1, 2])
def test_differences_match_jax(d):
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.normal(size=(5, 33)), axis=1)
    diffed = univariate.differences_of_order_d(torch.from_numpy(x), d)
    np.testing.assert_allclose(
        _np(diffed), _np(juni.differences_of_order_d(jnp.asarray(x), d)),
        rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        _np(univariate.inverse_differences_of_order_d(diffed, d)),
        _np(juni.inverse_differences_of_order_d(jnp.asarray(_np(diffed)),
                                                d)),
        rtol=RTOL, atol=1e-12)
    # other lags and start indices of the size-preserving forms
    np.testing.assert_allclose(
        _np(univariate.differences_at_lag(torch.from_numpy(x), 2, 3)),
        _np(juni.differences_at_lag(jnp.asarray(x), 2, 3)), rtol=RTOL)
    np.testing.assert_allclose(
        _np(univariate.inverse_differences_at_lag(torch.from_numpy(x), 3, 4)),
        _np(juni.inverse_differences_at_lag(jnp.asarray(x), 3, 4)),
        rtol=RTOL)


def _nan_padded(rng):
    x = rng.normal(size=(6, 24))
    x[0, :5] = np.nan          # leading padding
    x[1, -7:] = np.nan         # trailing padding
    x[2, :3] = np.nan
    x[2, -2:] = np.nan
    x[3, :] = np.nan           # all-NaN lane
    x[4, 1:] = np.nan          # one observation
    return x


def test_ragged_helpers_match_jax():
    x = _nan_padded(np.random.default_rng(2))
    for got, want in zip(ragged._windows(torch.from_numpy(x)),
                         jragged._windows(jnp.asarray(x))):
        np.testing.assert_array_equal(_np(got), _np(want))
    for got, want in zip(ragged._left_align(torch.from_numpy(x)),
                         jragged._left_align(jnp.asarray(x))):
        np.testing.assert_array_equal(_np(got), _np(want))
    aligned, length = ragged.ragged_view(torch.from_numpy(x))
    j_aligned, j_length = jragged.ragged_view(jnp.asarray(x))
    np.testing.assert_array_equal(_np(aligned), _np(j_aligned))
    np.testing.assert_array_equal(_np(length), _np(j_length))

    dense = np.ones((3, 8))
    same, none = ragged.ragged_view(torch.from_numpy(dense))
    assert none is None and np.array_equal(_np(same), dense)

    nv = np.array([3, 10, 0, 7])
    np.testing.assert_array_equal(
        _np(ragged.step_weights(9, torch.from_numpy(nv)[:, None], offset=2,
                                dtype=torch.float64)),
        _np(jragged.step_weights(9, jnp.asarray(nv)[:, None], offset=2,
                                 dtype=jnp.float64)))

    with pytest.warns(UserWarning, match="shorter than"):
        short = ragged.short_lanes(torch.from_numpy(nv), 5, "test")
    with pytest.warns(UserWarning, match="shorter than"):
        j_short = jragged.short_lanes(jnp.asarray(nv), 5, "test")
    np.testing.assert_array_equal(_np(short), _np(j_short))
    assert ragged.short_lanes(torch.from_numpy(nv), 0, "test") is None

    params = np.arange(8.0).reshape(4, 2)
    conv = np.array([True, True, False, True])
    got = ragged.apply_short_quarantine(torch.from_numpy(params),
                                        torch.from_numpy(conv), short)
    want = jragged.apply_short_quarantine(jnp.asarray(params),
                                          jnp.asarray(conv), j_short)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_ragged_view_rejects_interior_gaps():
    x = np.ones((2, 10))
    x[1, 4] = np.nan
    with pytest.raises(ValueError, match="strictly inside"):
        ragged.ragged_view(torch.from_numpy(x))


@pytest.mark.parametrize("p", [1, 5, 20])
def test_spd_solve_and_inverse_match_jax(p):
    # p = 20 takes the library Cholesky past the unrolled limit of 16
    rng = np.random.default_rng(3)
    a = rng.normal(size=(7, p, p + 3))
    A = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(p)
    b = rng.normal(size=(7, p))
    # well-conditioned SPD systems: 1e-10 covers the two orders of the
    # unrolled factorisation's roundoff
    np.testing.assert_allclose(
        _np(linalg.spd_solve(torch.from_numpy(A), torch.from_numpy(b))),
        _np(jlinalg.spd_solve(jnp.asarray(A), jnp.asarray(b))), rtol=1e-10)
    np.testing.assert_allclose(
        _np(linalg.spd_inverse(torch.from_numpy(A))),
        _np(jlinalg.spd_inverse(jnp.asarray(A))), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("add_intercept", [False, True])
def test_ols_gram_matches_jax(weighted, add_intercept):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(9, 60))
    Xs = jlag.lag_stack(jnp.asarray(x), 3)
    y = x[:, 3:]
    w = None
    if weighted:
        nv = rng.integers(20, 58, size=9)
        w = (np.arange(57)[None, :] < nv[:, None]).astype(np.float64)
    got = linalg.ols_gram(torch.from_numpy(np.asarray(Xs)),
                          torch.from_numpy(y), add_intercept,
                          None if w is None else torch.from_numpy(w))
    want = jlinalg.ols_gram(Xs, jnp.asarray(y), add_intercept,
                            None if w is None else jnp.asarray(w))
    # gram solves on well-conditioned lag designs, float64 both sides
    for g, wt in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(wt), rtol=1e-10, atol=1e-12)


def test_model_base_matches_jax():
    conf = np.array([0.5, 0.8, 0.95, 0.99])
    # erfinv in float64 both sides
    np.testing.assert_allclose(
        _np(base.normal_quantile(torch.from_numpy(conf))),
        _np(jbase.normal_quantile(jnp.asarray(conf), jnp.float64)),
        rtol=1e-12)
    assert abs(float(base.normal_quantile(0.95)) - 1.959963984540054) < 1e-12

    res = MinimizeResult(torch.zeros(4, 2),
                         torch.tensor([1.0, np.nan, 2.0, 3.0]),
                         torch.tensor([True, True, True, False]),
                         torch.tensor([3, 4, 5, 50]))
    diag = base.diagnostics_from(res, torch.tensor([True, True, False, True]))
    j_diag = jbase.diagnostics_from(
        jopt.MinimizeResult(*(jnp.asarray(_np(t)) for t in res[:4])),
        jnp.asarray([True, True, False, True]))
    for g, w in zip(diag[:3], j_diag[:3]):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert res.attempts is None and diag.attempts is None \
        and j_diag.attempts is None


_PORT = Path(__file__).resolve().parents[1]


def _port_sources():
    files = sorted((_PORT / "spark_timeseries_tpu_torch").rglob("*.py"))
    return files + [_PORT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference():
    banned = {"jax", "jaxlib", "spark_timeseries_tpu"}
    offenders = []
    for path in _port_sources():
        src = path.read_text()
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in banned]
        # dynamic imports by name
        if re.search(r"import_module\(\s*['\"](jax|spark_timeseries_tpu"
                     r"(?!_torch))", src) or re.search(r"\bimport jax\b",
                                                       src):
            offenders.append(f"{path.name}: dynamic import")
    assert len(_port_sources()) > 10
    # the state-space core and the exogenous-regressor families are held
    names = {p.relative_to(_PORT).as_posix() for p in _port_sources()}
    assert {"spark_timeseries_tpu_torch/statespace/ssm.py",
            "spark_timeseries_tpu_torch/statespace/kalman.py",
            "spark_timeseries_tpu_torch/statespace/convert.py",
            "spark_timeseries_tpu_torch/models/arimax.py",
            "spark_timeseries_tpu_torch/models/autoregression_x.py",
            "spark_timeseries_tpu_torch/models/regression_arima.py",
            "chip_smoke.py"} <= names
    assert not offenders, offenders
