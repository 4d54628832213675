"""The series-major one-pass ARMA kernels' own source, run on the host.

``csrc/arma_ne_rows.cuh`` (the normal equations) and
``csrc/arma_ne.sse.cu`` (the cost alone) stage each block's rows of the
panel through shared memory: ``csrc/stage_rows.cuh`` copies them whole
before the block's threads run the recurrence (or, for rows too long to
stage, each thread reads its row from global memory), and the outputs go
back through shared memory.  Here g++ compiles those sources with a stub
CUDA header (no FMA contraction; ``cp.async`` an immediate copy) and
runs each block's threads as host threads meeting at a ``std::barrier``,
so the staging (whole rows, rows read in place, partial blocks, the
output layout) runs as the card runs it.  Each lane's result is held against the
plain PyTorch pass bit for bit (both round every product and sum on its
own in float32) and against the time-major kernels of the same sources
(``arma_ne_kernel``, ``arma_css_kernel``), run lane by lane, bit for
bit, dense, ragged and masked, at awkward widths and tiles.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch import _build
from spark_timeseries_tpu_torch.ops import arma_ne

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
extern dim3 blockIdx, blockDim;
extern thread_local dim3 threadIdx;
extern float g_smem[];
void __syncthreads();
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132; return 0;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute,
                                        int) { return 0; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, const void*) {
  return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int*, const void*, int, size_t) { return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
// unfused, as the plain pass rounds each product
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
using std::isfinite;
using std::isnan;
inline float fabsf(float a) { return std::fabs(a); }
"""

# Runs one case: the series-major kernel block by block (each block's
# threads as host threads at a barrier) and the time-major kernel lane by
# lane on the transposed operands; writes both results.
_HARNESS = r"""
#include <barrier>
#include <cstdio>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
dim3 blockIdx, blockDim;
thread_local dim3 threadIdx;
alignas(16) float g_smem[stage_rows_host_floats];
static std::barrier<>* g_bar = nullptr;
void __syncthreads() { g_bar->arrive_and_wait(); }
#include "arma_ne.cu"
#include "arma_ne.sse.cu"
using namespace arma_ne;
// arma_ne.cu's dispatch names every order's launchers, which the orders
// files define; the harness launches none of them
namespace arma_ne {
#define NO_LAUNCH(P, Q)                                                   \
  cudaError_t ne_launch_##P##_##Q(int, const float*, const float*,        \
                                  const float*, float*, int, int,         \
                                  cudaStream_t) { return 1; }             \
  cudaError_t ne_rows_launch_##P##_##Q(int, const RowsArgs&,              \
                                       const stage_rows::Tile&,           \
                                       cudaStream_t) { return 1; }        \
  LmKernel lm_pick_##P##_##Q(int, bool) { return nullptr; }
ARMA_NE_FOR_EACH_ORDER(NO_LAUNCH)
}  // namespace arma_ne

template <class F> void run_rows(const stage_rows::Tile& tl, F f) {
  blockDim = dim3(tl.lanes);
  for (int b = 0; b < tl.blocks; ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(tl.lanes);
    g_bar = &bar;
    std::vector<std::thread> ts;
    for (int i = 0; i < tl.lanes; ++i)
      ts.emplace_back([&, i] { threadIdx = dim3(i); f(); });
    for (auto& t : ts) t.join();
  }
}
template <class F> void run_lanes(int S, F f) {
  blockDim = dim3(128);
  for (int s = 0; s < S; ++s) {
    blockIdx = dim3(s / 128);
    threadIdx = dim3(s % 128);
    f();
  }
}

struct Case {
  int cost, p, q, icpt, S, n, ragged, masked, lanes;
  std::vector<float> prm, y, nv, mask, prm_t, y_t;
};

template <int P, int Q, int ICPT, bool R>
void ne(Case& c, FILE* o) {
  const int k = ICPT + P + Q, S = c.S;
  stage_rows::Tile tl;
  if (!stage_rows::make_tile(S, c.n, ne_rows_out_floats<ICPT + P + Q>(),
                             c.lanes, 132, &tl)) throw 2;
  std::vector<float> jtj(S * k * k), jtr(S * k), sse(S);
  RowsArgs A{c.prm.data(), c.y.data(), R ? c.nv.data() : nullptr,
             c.masked ? c.mask.data() : nullptr, jtj.data(), jtr.data(),
             sse.data(), S, c.n, P};
  run_rows(tl, [&] { arma_ne_rows_kernel<P, Q, ICPT, R>(A, tl); });
  const int n_out = 1 + k * (k + 1) / 2 + k;
  std::vector<float> out(n_out * S);
  run_lanes(S, [&] {
    arma_ne_kernel<P, Q, ICPT, R>(c.prm_t.data(), c.y_t.data(),
                                  R ? c.nv.data() : nullptr, out.data(), S,
                                  c.n);
  });
  fwrite(jtj.data(), 4, jtj.size(), o);
  fwrite(jtr.data(), 4, jtr.size(), o);
  fwrite(sse.data(), 4, sse.size(), o);
  fwrite(out.data(), 4, out.size(), o);
}

template <int P, int Q, int ICPT, bool R>
void css(Case& c, FILE* o) {
  const int S = c.S;
  stage_rows::Tile tl;
  if (!stage_rows::make_tile(S, c.n, 0, c.lanes, 132, &tl)) throw 2;
  std::vector<float> sse(S), out(S);
  RowsArgs A{c.prm.data(), c.y.data(), R ? c.nv.data() : nullptr, nullptr,
             nullptr, nullptr, sse.data(), S, c.n, c.p};
  run_rows(tl, [&] { arma_css_rows_kernel<P, Q, ICPT, R>(A, tl); });
  run_lanes(S, [&] {
    arma_css_kernel<P, Q, ICPT, R>(c.prm_t.data(), c.y_t.data(),
                                   R ? c.nv.data() : nullptr, out.data(), S,
                                   c.n, c.p);
  });
  fwrite(sse.data(), 4, sse.size(), o);
  fwrite(out.data(), 4, out.size(), o);
}

template <int P, int Q, int ICPT>
bool dispatch(Case& c, FILE* o) {
  const int p = P < 0 ? c.p : P;
  if (c.p != p || c.q != Q || c.icpt != ICPT) return false;
  if (c.cost) {
    if (c.ragged) css<P, Q, ICPT, true>(c, o); else css<P, Q, ICPT, false>(c, o);
  } else if constexpr (P >= 0) {
    if (c.ragged) ne<P, Q, ICPT, true>(c, o); else ne<P, Q, ICPT, false>(c, o);
  }
  return true;
}

template <class T> void rd(FILE* f, std::vector<T>& v) {
  if (fread(v.data(), sizeof(T), v.size(), f) != v.size()) throw 1;
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<int> h(9);
  rd(f, h);
  Case c{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8]};
  const int k = c.icpt + c.p + c.q;
  c.prm.resize(c.S * k); c.y.resize(c.S * c.n); c.nv.resize(c.S);
  c.mask.resize(c.S * k);
  rd(f, c.prm); rd(f, c.y); rd(f, c.nv); rd(f, c.mask);
  fclose(f);
  c.prm_t.resize(c.S * k); c.y_t.resize(c.S * c.n);
  for (int s = 0; s < c.S; ++s) {
    for (int x = 0; x < k; ++x)
      c.prm_t[x * c.S + s] = c.prm[s * k + x] * (c.masked ? c.mask[s * k + x] : 1.0f);
    for (int t = 0; t < c.n; ++t) c.y_t[t * c.S + s] = c.y[s * c.n + t];
  }
  FILE* o = fopen(argv[2], "wb");
  const bool ok = dispatch<2, 2, 1>(c, o) || dispatch<1, 0, 0>(c, o) ||
                  dispatch<0, 1, 1>(c, o) || dispatch<3, 2, 1>(c, o) ||
                  dispatch<5, 5, 1>(c, o) || dispatch<5, 0, 1>(c, o) ||
                  dispatch<1, 5, 0>(c, o) || dispatch<-1, 1, 1>(c, o);
  fclose(o);
  return ok ? 0 : 3;
}
"""


def _host_source(name: str) -> str:
    """A source of ``csrc/`` as the host compiles it: launches dropped,
    shared memory the harness's array, ``cp.async`` an immediate copy and
    its group waits nothing."""
    src = (_build.CSRC / name).read_text()
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src = src.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    src = re.sub(r"(void cp_async4\(float\* dst, const float\* src\) \{)"
                 r"(?:.|\n)*?\n\}", r"\1 *dst = *src; }", src)
    return re.sub(r"asm volatile\((?:.|\n)*?\);", "", src)


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    d = tmp_path_factory.mktemp("rows_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    for name in ("arma_ne.cuh", "arma_ne_rows.cuh", "stage_rows.cuh",
                 "arma_ne.cu", "arma_ne.sse.cu"):
        (d / name).write_text(_host_source(name))
    (d / "harness.cpp").write_text(_HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-Dstage_rows_host_floats=25600",
                    f"-I{d}", "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True)
    return d


def _run(d, cost, p, q, icpt, prm, y, nv, mask, lanes):
    S, n = y.shape
    k = icpt + p + q
    f32 = np.float32
    with open(d / "in.bin", "wb") as f:
        np.array([cost, p, q, icpt, S, n, nv is not None, mask is not None,
                  lanes], np.int32).tofile(f)
        prm.astype(f32).tofile(f)
        y.astype(f32).tofile(f)
        (np.zeros(S, f32) if nv is None else nv.astype(f32)).tofile(f)
        (np.ones((S, k), f32) if mask is None else mask.astype(f32)).tofile(f)
    subprocess.run([str(d / "harness"), str(d / "in.bin"),
                    str(d / "out.bin")], check=True)
    return np.fromfile(d / "out.bin", f32)


def _panel(rng, S, n):
    e = rng.normal(size=(S, n + 8))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 0.5 + 0.3 * y[:, t - 1] + 0.2 * y[:, t - 2] + e[:, t] \
            + 0.4 * e[:, t - 1]
    return y[:, 8:].astype(np.float32)


def _bitwise(a, b):
    return torch.equal(torch.as_tensor(a).view(torch.int32),
                       torch.as_tensor(b).view(torch.int32))


# (p, q, icpt), S, n_obs, lanes: whole rows staged, rows too long to
# stage read from global memory (128 lanes of 150 steps, 32 of 600),
# partial blocks, a single lane
NE_CASES = [((2, 2, 1), 200, 61, 0), ((2, 2, 1), 33, 61, 32),
            ((1, 0, 0), 1, 40, 0), ((0, 1, 1), 97, 33, 64),
            ((3, 2, 1), 130, 150, 128), ((5, 5, 1), 40, 29, 32),
            ((2, 2, 1), 70, 600, 0)]


@pytest.mark.parametrize("mode", ["dense", "ragged", "masked"])
@pytest.mark.parametrize("order,S,n,lanes", NE_CASES)
def test_ne_rows_kernel_on_the_host(host_rows, order, S, n, lanes, mode):
    p, q, icpt = order
    k = icpt + p + q
    rng = np.random.default_rng(S + n + k)
    y = _panel(rng, S, n)
    prm = (0.2 * rng.normal(size=(S, k))).astype(np.float32)
    nv = rng.integers(max(p, q) + 1, n + 1, S).astype(np.float32) \
        if mode == "ragged" else None
    mask = (rng.random((S, k)) > 0.3).astype(np.float32) \
        if mode == "masked" else None
    out = _run(host_rows, 0, p, q, icpt, prm, y, nv, mask, lanes)
    jtj = out[:S * k * k].reshape(S, k, k)
    jtr = out[S * k * k:S * k * (k + 1)].reshape(S, k)
    sse = out[S * k * (k + 1):S * (k * (k + 1) + 1)]
    packed = out[S * (k * (k + 1) + 1):].reshape(-1, S)
    t = torch.from_numpy
    want = arma_ne.normal_equations_plain(
        t(prm), t(y), p, q, icpt, mask=None if mask is None else t(mask),
        n_valid=None if nv is None else t(nv))
    for got, w in zip((jtj, jtr, sse), want):
        assert _bitwise(got, w)
    # the time-major kernel of the same sources, unpacked and scaled as
    # normal_equations_time_major does
    old = arma_ne._unpack(t(packed), k)
    if mask is not None:
        old = arma_ne._masked_ne(*old, t(mask))
    for got, w in zip((jtj, jtr, sse), old):
        assert _bitwise(got, w)


# (p, q, icpt), S, n_obs, lanes; p = 7 is the runtime-p form, which
# reads its y lags from the row, staged or (128 lanes of 150 steps) in
# global memory
CSS_CASES = [((2, 2, 1), 200, 61, 0), ((5, 0, 1), 70, 50, 32),
             ((1, 5, 0), 33, 40, 64), ((7, 1, 1), 65, 45, 32),
             ((7, 1, 1), 129, 150, 128)]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("order,S,n,lanes", CSS_CASES)
def test_css_rows_kernel_on_the_host(host_rows, order, S, n, lanes, ragged):
    p, q, icpt = order
    k = icpt + p + q
    rng = np.random.default_rng(S + n + k + 1)
    y = _panel(rng, S, n)
    prm = (0.15 * rng.normal(size=(S, k))).astype(np.float32)
    nv = rng.integers(max(p, q) + 1, n + 1, S).astype(np.float32) \
        if ragged else None
    out = _run(host_rows, 1, p, q, icpt, prm, y, nv, None, lanes)
    sse, old = out[:S], out[S:]
    want = arma_ne.css_cost_plain(torch.from_numpy(prm), torch.from_numpy(y),
                                  p, q, icpt, n_valid=None if nv is None
                                  else torch.from_numpy(nv))
    assert _bitwise(sse, want)
    assert _bitwise(sse, old)
