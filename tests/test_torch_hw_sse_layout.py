"""The one-pass Holt-Winters kernel over the callers' layout, on the CPU.

``ops.hw_sse.value_and_grad`` reads the caller's ``(S, n)`` rows and
``(S, 3)`` parameters where they lie (``prepare(..., time_major=False)``:
``y`` a transposed view, no copy); on a CPU tensor that view runs the
plain pass, held here against the JAX package's ``_hw_sse_value_and_grad``
at float64.

On a card the view reaches ``hw_sse_rows_kernel``
(``csrc/hw_sse.rows.cu``): its season ring in shared memory, or in a
global scratch for a period too long for a block, and ``y`` staged a
window at a time through a tile a warp.  Here g++ compiles that source
with a stub CUDA header (the step's written-out roundings as the card
rounds them, nothing else contracted; ``cp.async`` an immediate copy)
and runs each block's warps as host threads meeting at a barrier a warp,
so the tiles, windows, ring slots, partial blocks and dead lanes run as
on the card.  Every lane is held bit for bit against the same
``hw_step`` run lane by lane over a plain ring, and within float32's
spread of the plain pass.  (On the card, ``tests/test_torch_cuda.py``
holds the kernel bit for bit against the time-major ``hw_sse_kernel`` it
replaced.)
"""

import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import holt_winters as jhw
from spark_timeseries_tpu_torch import _build
from spark_timeseries_tpu_torch.ops import hw_sse

torch.set_num_threads(1)


def _panel(rng, S, n, m):
    """The bench recipe ``100 + 0.5 t + 10 sin(2πt/m) + N(0, 2²)``."""
    t = np.arange(n)
    return 100.0 + 0.5 * t + 10.0 * np.sin(2 * np.pi * t / m) \
        + rng.normal(0.0, 2.0, size=(S, n))


def _ragged(rng, y, m):
    """Left-aligned, zero-tailed lanes and their valid lengths (>= 2m+1)."""
    S, n = y.shape
    nv = rng.integers(2 * m + 1, n + 1, size=S)
    return np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0), nv


@pytest.mark.parametrize("m", [4, 12, 52])
@pytest.mark.parametrize("ragged", [False, True])
def test_value_and_grad_on_the_rows_matches_jax(m, ragged):
    rng = np.random.default_rng(m + ragged)
    S, n = 12, 3 * m + 7
    y = _panel(rng, S, n, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    params = rng.uniform(0.05, 0.95, size=(S, 3))
    f, g = hw_sse.value_and_grad(
        torch.from_numpy(params), torch.from_numpy(y), m, "additive",
        n_valid=None if nv is None else torch.from_numpy(nv))

    def one(p, s, *v):
        return jhw._hw_sse_value_and_grad(p, s, m, "additive",
                                          n_valid=v[0] if v else None)
    extra = () if nv is None else (jnp.asarray(nv),)
    jf, jg = jax.vmap(one)(jnp.asarray(params), jnp.asarray(y), *extra)
    # float64 both sides; the tangent rows add their unit-vector term in
    # another order than the JAX pass
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-12)
    scale = np.maximum(np.abs(np.asarray(jg)).max(axis=1),
                       np.abs(np.asarray(jf)))[:, None]
    assert (np.abs(g.numpy() - np.asarray(jg)) / scale).max() < 1e-12


def test_prepare_leaves_the_rows_in_place():
    rng = np.random.default_rng(7)
    series = torch.from_numpy(_panel(rng, 9, 40, 4).astype(np.float32))
    inp = hw_sse.prepare(series, 4, "additive", time_major=False)
    # y is series[:, 4:] seen time-major: the caller's storage, no copy
    assert inp.y.data_ptr() == series[:, 4:].data_ptr()
    assert inp.y.stride() == (1, 40) and inp.y.shape == (36, 9)
    copied = hw_sse.prepare(series, 4, "additive")
    assert copied.y.is_contiguous() and torch.equal(copied.y, inp.y)
    assert torch.equal(copied.init, inp.init)
    # the plain pass reads either layout, and the evaluator hands it the
    # parameters as a (3, S) view of the caller's (S, 3)
    x = torch.from_numpy(rng.uniform(0.05, 0.95, (9, 3)).astype(np.float32))
    got = hw_sse.evaluator(inp)(x)
    want = hw_sse.evaluator(copied)(x.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_STUB = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
extern dim3 blockIdx, blockDim, gridDim;
extern thread_local dim3 threadIdx;
extern float g_smem[];
void __syncwarp();
void __syncthreads();
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 132 : 232448; return 0;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute,
                                        int) { return 0; }
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                         const void*) {
  a->numRegs = 0; a->localSizeBytes = 0; return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* b, const void*, int, size_t) { *b = 1; return 0; }
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                                    cudaStream_t) { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int atomicAdd(int* p, int v) { const int o = *p; *p += v; return o; }
using std::isfinite;
inline float fabsf(float a) { return std::fabs(a); }
"""

# Runs one case: the rows kernel block by block (each warp's threads as
# host threads at a barrier) on a series-major or a time-major y, and
# the same step lane by lane over a plain ring; writes both (4, S)
# outputs and the tile.
_HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <memory>
#include <thread>
#include <vector>
#include "cuda_runtime.h"
dim3 blockIdx, blockDim, gridDim;
thread_local dim3 threadIdx;
alignas(16) float g_smem[hw_host_smem_floats];
static std::vector<std::unique_ptr<std::barrier<>>> g_bars;
void __syncwarp() { g_bars[threadIdx.x / 32]->arrive_and_wait(); }
void __syncthreads() {}
#include "hw_sse.rows.cu"

template <class T> void rd(FILE* f, std::vector<T>& v) {
  if (fread(v.data(), sizeof(T), v.size(), f) != v.size()) throw 1;
}

// the lane loop: (S, n) series, (S, 3) params, (2 + m, S) init
template <bool ADD, bool R, bool REG>
void ref_lanes(int m, int S, int n, const float* prm, const float* series,
               const float* init, const float* nv, float* out) {
  std::vector<float> ring(4 * m);
  for (int s = 0; s < S; ++s) {
    const hw::Smoothing p(prm[3 * s], prm[3 * s + 1], prm[3 * s + 2]);
    float level = init[s], trend = init[S + s], sse = 0.0f;
    float dl[3] = {0, 0, 0}, db[3] = {0, 0, 0}, grad[3] = {0, 0, 0};
    for (int j = 0; j < m; ++j) {
      ring[4 * j] = init[(2 + j) * S + s];
      ring[4 * j + 1] = ring[4 * j + 2] = ring[4 * j + 3] = 0.0f;
    }
    for (int t = 0; t + m < n; ++t) {
      float* r = &ring[4 * (t % m)];
      float ds[3] = {r[1], r[2], r[3]};
      hw::hw_step<ADD, R, REG>(
          series[s * n + m + t], hw::step_weight<R>(m + t, R ? nv[s] : 0.0f),
          p, level, trend, dl, db, r[0], ds, sse, grad);
      for (int c = 0; c < 3; ++c) r[1 + c] = ds[c];
    }
    out[s] = sse;
    for (int c = 0; c < 3; ++c) out[(1 + c) * S + s] = grad[c];
  }
}

template <bool ADD, bool R>
void ref_of(int m, int S, int n, const float* prm, const float* series,
            const float* init, const float* nv, float* out) {
  if (register_period(m))
    ref_lanes<ADD, R, true>(m, S, n, prm, series, init, nv, out);
  else
    ref_lanes<ADD, R, false>(m, S, n, prm, series, init, nv, out);
}

int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<int> h(8);
  rd(f, h);
  const int m = h[0], add = h[1], rag = h[2], S = h[3], n_steps = h[4],
            sms = h[5], rows = h[6], shift = h[7], n = n_steps + m;
  std::vector<float> prm(S * 3), series(S * n), init((2 + m) * S), nv(S);
  rd(f, prm); rd(f, series); rd(f, init); rd(f, nv);
  fclose(f);
  // the rows `shift` floats past a 32-byte boundary, as a caller's panel
  // may lie: the windows start where the rows' pieces align
  std::vector<float> store(S * n + 16);
  float* rows_at = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(store.data()) + 31) & ~uintptr_t(31)) + shift;
  std::copy(series.begin(), series.end(), rows_at);
  std::vector<float> y_t(n_steps * S), prm_t(3 * S);
  for (int s = 0; s < S; ++s) {
    for (int t = 0; t < n_steps; ++t) y_t[t * S + s] = series[s * n + m + t];
    for (int c = 0; c < 3; ++c) prm_t[c * S + s] = prm[s * 3 + c];
  }
  Tile tl;
  make_tile(S, m, sms, 232448, &tl);
  // series-major: the rows from column m and (S, 3) parameters seen as
  // (3, S); time-major: the copies, contiguous
  RowsArgs A{rows ? prm.data() : prm_t.data(), init.data(),
             rows ? rows_at + m : y_t.data(), rag ? nv.data() : nullptr,
             nullptr, nullptr, rows ? 3LL : 1LL, rows ? 1LL : S,
             rows ? (long long)n : 1LL, rows ? 1LL : S, S, n_steps, m, 0};
  A.t_first = first_window(A.y, A.y_step, A.y_lane);
  std::vector<float4> ring(tl.ring_in_smem ? 0 : (size_t)m * tl.blocks * tl.lanes);
  A.ring = tl.ring_in_smem ? nullptr : ring.data();
  std::vector<float> out(4 * S, -1.0f), old(4 * S, -2.0f);
  A.out = out.data();
  blockDim = dim3(tl.lanes);
  gridDim = dim3(tl.blocks);
  auto kernel = pick_rows(add != 0, rag != 0, m, tl.ring_in_smem != 0,
                          rows != 0);
  for (int b = 0; b < tl.blocks; ++b) {
    blockIdx = dim3(b);
    g_bars.clear();
    for (int w = 0; w < tl.lanes / 32; ++w)
      g_bars.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> ts;
    for (int i = 0; i < tl.lanes; ++i)
      ts.emplace_back([&, i] { threadIdx = dim3(i); kernel(A); });
    for (auto& t : ts) t.join();
  }
  const float* args[] = {prm.data(), series.data(), init.data(), nv.data()};
  if (add) {
    if (rag) ref_of<true, true>(m, S, n, args[0], args[1], args[2], args[3], old.data());
    else ref_of<true, false>(m, S, n, args[0], args[1], args[2], args[3], old.data());
  } else {
    if (rag) ref_of<false, true>(m, S, n, args[0], args[1], args[2], args[3], old.data());
    else ref_of<false, false>(m, S, n, args[0], args[1], args[2], args[3], old.data());
  }
  FILE* o = fopen(argv[2], "wb");
  const int tile[4] = {tl.lanes, tl.ring_in_smem, tl.smem, A.t_first};
  fwrite(tile, 4, 4, o);
  fwrite(out.data(), 4, out.size(), o);
  fwrite(old.data(), 4, old.size(), o);
  fclose(o);
  return 0;
}
"""


def _host_source(name: str) -> str:
    """A source of ``csrc/`` as the host compiles it: launches dropped,
    shared memory the harness's array, ``cp.async`` an immediate copy and
    its group waits nothing."""
    src = (_build.CSRC / name).read_text()
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src = re.sub(r"extern __shared__ float (\w+)\[\];", r"float* \1 = g_smem;",
                 src)
    src = re.sub(r"(void cp_async4\(float\* dst, const float\* src\) \{)"
                 r"(?:.|\n)*?\n\}", r"\1 *dst = *src; }", src)
    return re.sub(r"asm volatile\((?:.|\n)*?\);", "", src)


@pytest.fixture(scope="module")
def host_hw(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    d = tmp_path_factory.mktemp("hw_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    for name in ("hw_step.cuh", "stage_rows.cuh", "hw_sse.rows.cu"):
        (d / name).write_text(_host_source(name))
    (d / "harness.cpp").write_text(_HARNESS)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-Dhw_host_smem_floats=58112",
                    f"-I{d}", "-o", str(d / "harness"),
                    str(d / "harness.cpp")], check=True)
    return d


def _bitwise(a, b):
    return torch.equal(torch.as_tensor(a).view(torch.int32),
                       torch.as_tensor(b).view(torch.int32))


# period, model, ragged, S, n_obs, the SMs the tile is made for and the
# block it picks for them (the widest that gives every SM two blocks),
# layout, the rows' offset past a 32-byte boundary (floats) and the first
# window it gives (series-major rows whose length is a multiple of 8
# start their windows where the rows' 8-float pieces align): S = 1,
# partial blocks and warps, blocks of 32, 64 and 128 lanes, periods in
# and out of the time-major kernel's registers (their two roundings), a
# ring too long for shared memory (m = 460 in a global scratch), both
# layouts, steps ending in a partial window of every length from 1 to 7,
# one of them the only window
HOST_CASES = [
    (4, "additive", False, 1, 11, 132, 32, "rows", 0, 0),
    (5, "multiplicative", True, 37, 40, 132, 32, "rows", 2, -7),
    (7, "additive", True, 100, 69, 1, 64, "time_major", 0, 0),
    (12, "additive", False, 200, 120, 132, 32, "rows", 0, -4),
    (12, "multiplicative", False, 130, 61, 1, 128, "rows", 0, 0),
    (24, "multiplicative", True, 65, 77, 132, 32, "time_major", 0, 0),
    (52, "additive", True, 70, 158, 132, 32, "rows", 0, 0),
    (460, "additive", False, 33, 925, 132, 32, "rows", 0, 0),
]


@pytest.mark.parametrize(
    "m,model_type,ragged,S,n,sms,lanes,layout,shift,first", HOST_CASES)
def test_rows_kernel_on_the_host(host_hw, m, model_type, ragged, S, n, sms,
                                 lanes, layout, shift, first):
    rng = np.random.default_rng(m + S)
    y = _panel(rng, S, n, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    y = y.astype(np.float32)
    params = rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)
    t = torch.from_numpy
    inp = hw_sse.prepare(t(y), m, model_type,
                         None if nv is None else t(nv))
    f32 = np.float32
    d = host_hw
    with open(d / "in.bin", "wb") as fh:
        np.array([m, model_type == "additive", ragged, S, n - m, sms,
                  layout == "rows", shift], np.int32).tofile(fh)
        params.tofile(fh)
        y.tofile(fh)
        inp.init.numpy().astype(f32).tofile(fh)
        (np.zeros(S, f32) if nv is None else nv.astype(f32)).tofile(fh)
    subprocess.run([str(d / "harness"), str(d / "in.bin"),
                    str(d / "out.bin")], check=True)
    raw = np.fromfile(d / "out.bin", f32)
    tile = raw[:4].view(np.int32)
    got, old = raw[4:4 + 4 * S].reshape(4, S), raw[4 + 4 * S:].reshape(4, S)
    assert tile[0] == lanes                 # the block's lanes
    assert tile[1] == (m != 460)            # the ring in shared memory
    assert tile[3] == first                 # the first window's step
    assert _bitwise(got, old)
    # the plain pass rounds otherwise where torch's CPU addcmul fuses a
    # multiply-add: float32's own spread over the lane's steps
    plain = hw_sse._packed_plain(t(params).T, inp).numpy()
    np.testing.assert_allclose(got[0], plain[0], rtol=1e-4)
    scale = np.maximum(np.abs(plain[1:]).max(axis=0), np.abs(plain[0]))
    assert (np.abs(got[1:] - plain[1:]) / scale).max() < 1e-3
