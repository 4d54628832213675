// Fused Holt-Winters SSE value and gradient for the projected-gradient fit.
//
// Replaces the Pallas TPU kernel docs/experiments/hw_pallas.py::_hw_kernel
// (itself the drop-in for models/holt_winters.py::_hw_sse_value_and_grad)
// and computes its function: per series lane, one pass over the steps
// t >= m of the R-style components recurrence at (alpha, beta, gamma),
// carrying the level, trend and season ring and their tangents with
// respect to (alpha, beta, gamma), and accumulating
//
//   e_t  = y_t - (base + s)  (additive)  |  y_t - base * s  (multiplicative)
//   sse += e^2,  grad += 2 e de/d(alpha, beta, gamma)
//
// with base = level + trend and s the season slot t mod m.  The initial
// components are data-only and come in precomputed, so the tangents start
// at zero.  Ragged lanes weight only the accumulators' e and de by
// (m + t < nv), AFTER the ring updates (the JAX pass's order; the zero
// tail still runs through the recurrence).
//
// Layout (time-major, so a warp's loads at one step are 32 consecutive
// floats): params (3, S), init (2 + m, S) = (level0, trend0, season0[m]),
// y (n_steps, S) = series[m:], nv (S,) or null, out (4, S) =
// (sse, dsse/dalpha, dsse/dbeta, dsse/dgamma).  All float32.
//
// Design: one thread per lane.  For the periods users fit most (m = 4, 7,
// 12, 24) the ring and its tangents (4m floats; 60 floats of carry in all
// at m = 12) live in registers: the kernel is templated on M and its time
// loop unrolled by M, so step j of each group of M reads and rewrites slot
// j.  Any other m runs the generic form, whose ring lives in a scratch
// buffer (4m, S) the wrapper allocates, slot-major so its accesses stay
// coalesced.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores)
// at the main path's m = 12, n = 120, S = 131072: the call must read y
// (108 x S floats, 56.6 MB), init (14 x S, 7.3 MB) and params (1.6 MB) and
// write out (2.1 MB): 67.6 MB, ~20 us.  An additive lane-step is 81 flop
// (base 4, e 2, de 6, lw 1, dlw 3, level 4, dlevel 11, trend 5, dtrend 15,
// sw 1, dsw 3, dseason 12, season 3, sse 2, grad 9), 1.15 GFLOP in all,
// ~17 us.  So bytes bound it; each lane's step is a dependent chain of ~15
// operations, hidden only by the ~32 resident warps per SM that 1024
// blocks of 128 threads give.

#include <cuda_runtime.h>

namespace {

// One step of the recurrence and its tangents on one ring slot (s, ds).
template <bool ADD, bool RAGGED>
__device__ __forceinline__ void hw_step(
    const float x, const float w, const float a, const float b,
    const float g, float& level, float& trend, float (&dl)[3],
    float (&db)[3], float& s, float (&ds)[3], float& sse,
    float (&grad)[3]) {
  const float base = level + trend;
  float dbase[3], de[3], dlw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dbase[j] = dl[j] + db[j];
  float e, lw;
  if (ADD) {
    e = x - (base + s);
#pragma unroll
    for (int j = 0; j < 3; ++j) de[j] = -(dbase[j] + ds[j]);
    lw = x - s;
#pragma unroll
    for (int j = 0; j < 3; ++j) dlw[j] = -ds[j];
  } else {
    e = x - base * s;
#pragma unroll
    for (int j = 0; j < 3; ++j) de[j] = -(dbase[j] * s + base * ds[j]);
    lw = x / s;
    const float x_s2 = x / (s * s);
#pragma unroll
    for (int j = 0; j < 3; ++j) dlw[j] = -x_s2 * ds[j];
  }
  const float nl = a * lw + (1.0f - a) * base;
  float dnl[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dnl[j] = a * dlw[j] + (1.0f - a) * dbase[j];
  dnl[0] += lw - base;
  const float nt = b * (nl - level) + (1.0f - b) * trend;
  float dnt[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dnt[j] = b * (dnl[j] - dl[j]) + (1.0f - b) * db[j];
  dnt[1] += nl - level - trend;
  float sw, dsw[3];
  if (ADD) {
    sw = x - nl;
#pragma unroll
    for (int j = 0; j < 3; ++j) dsw[j] = -dnl[j];
  } else {
    sw = x / nl;
    const float x_l2 = x / (nl * nl);
#pragma unroll
    for (int j = 0; j < 3; ++j) dsw[j] = -x_l2 * dnl[j];
  }
  float dns[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dns[j] = g * dsw[j] + (1.0f - g) * ds[j];
  dns[2] += sw - s;
  s = g * sw + (1.0f - g) * s;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ds[j] = dns[j];
    dl[j] = dnl[j];
    db[j] = dnt[j];
  }
  level = nl;
  trend = nt;
  if (RAGGED) {
    e *= w;
#pragma unroll
    for (int j = 0; j < 3; ++j) de[j] *= w;
  }
  sse += e * e;
#pragma unroll
  for (int j = 0; j < 3; ++j) grad[j] += 2.0f * e * de[j];
}

// Ring in registers: M static, the time loop unrolled by M.
template <int M, bool ADD, bool RAGGED>
__global__ void __launch_bounds__(128)
hw_sse_kernel(const float* __restrict__ params,
              const float* __restrict__ init, const float* __restrict__ y,
              const float* __restrict__ nv, float* __restrict__ out, int S,
              int n_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t stride = static_cast<size_t>(S);
  const float a = params[lane], b = params[stride + lane],
              g = params[2 * stride + lane];
  float level = init[lane], trend = init[stride + lane];
  float sea[M], dsea[M][3];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    sea[j] = init[(2 + j) * stride + lane];
    dsea[j][0] = dsea[j][1] = dsea[j][2] = 0.0f;
  }
  float dl[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  float sse = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
  const float n_valid = RAGGED ? nv[lane] : 0.0f;

  const float* yp = y + lane;
  int t = 0;
  for (; t + M <= n_steps; t += M) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float x = yp[static_cast<size_t>(t + j) * stride];
      const float w =
          RAGGED && !(static_cast<float>(M + t + j) < n_valid) ? 0.0f : 1.0f;
      hw_step<ADD, RAGGED>(x, w, a, b, g, level, trend, dl, db, sea[j],
                           dsea[j], sse, grad);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (t + j < n_steps) {
      const float x = yp[static_cast<size_t>(t + j) * stride];
      const float w =
          RAGGED && !(static_cast<float>(M + t + j) < n_valid) ? 0.0f : 1.0f;
      hw_step<ADD, RAGGED>(x, w, a, b, g, level, trend, dl, db, sea[j],
                           dsea[j], sse, grad);
    }
  }
  out[lane] = sse;
#pragma unroll
  for (int j = 0; j < 3; ++j) out[(1 + j) * stride + lane] = grad[j];
}

// Any period: the ring (season and its 3 tangents per slot) lives in the
// scratch buffer ring (4m, S), row 4*slot + c.
template <bool ADD, bool RAGGED>
__global__ void __launch_bounds__(128)
hw_sse_generic_kernel(const float* __restrict__ params,
                      const float* __restrict__ init,
                      const float* __restrict__ y,
                      const float* __restrict__ nv, float* __restrict__ ring,
                      float* __restrict__ out, int S, int n_steps, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t stride = static_cast<size_t>(S);
  const float a = params[lane], b = params[stride + lane],
              g = params[2 * stride + lane];
  float level = init[lane], trend = init[stride + lane];
  for (int j = 0; j < m; ++j) {
    float* r = ring + static_cast<size_t>(4 * j) * stride + lane;
    r[0] = init[(2 + j) * stride + lane];
    r[stride] = r[2 * stride] = r[3 * stride] = 0.0f;
  }
  float dl[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  float sse = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
  const float n_valid = RAGGED ? nv[lane] : 0.0f;

  const float* yp = y + lane;
  int slot = 0;
  for (int t = 0; t < n_steps; ++t) {
    float* r = ring + static_cast<size_t>(4 * slot) * stride + lane;
    float s = r[0];
    float ds[3] = {r[stride], r[2 * stride], r[3 * stride]};
    const float x = yp[static_cast<size_t>(t) * stride];
    const float w =
        RAGGED && !(static_cast<float>(m + t) < n_valid) ? 0.0f : 1.0f;
    hw_step<ADD, RAGGED>(x, w, a, b, g, level, trend, dl, db, s, ds, sse,
                         grad);
    r[0] = s;
    r[stride] = ds[0];
    r[2 * stride] = ds[1];
    r[3 * stride] = ds[2];
    if (++slot == m) slot = 0;
  }
  out[lane] = sse;
  for (int j = 0; j < 3; ++j) out[(1 + j) * stride + lane] = grad[j];
}

constexpr int kThreads = 128;

template <int M, bool ADD>
cudaError_t launch(const float* params, const float* init, const float* y,
                   const float* nv, float* out, int S, int n_steps,
                   cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    hw_sse_kernel<M, ADD, true><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, out, S, n_steps);
  else
    hw_sse_kernel<M, ADD, false><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, out, S, n_steps);
  return cudaGetLastError();
}

template <bool ADD>
cudaError_t launch_generic(const float* params, const float* init,
                           const float* y, const float* nv, float* ring,
                           float* out, int S, int n_steps, int m,
                           cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    hw_sse_generic_kernel<ADD, true><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, ring, out, S, n_steps, m);
  else
    hw_sse_generic_kernel<ADD, false><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, ring, out, S, n_steps, m);
  return cudaGetLastError();
}

template <bool ADD>
cudaError_t dispatch(const float* params, const float* init, const float* y,
                     const float* nv, float* ring, float* out, int S,
                     int n_steps, int m, cudaStream_t st) {
  switch (m) {
    case 4: return launch<4, ADD>(params, init, y, nv, out, S, n_steps, st);
    case 7: return launch<7, ADD>(params, init, y, nv, out, S, n_steps, st);
    case 12: return launch<12, ADD>(params, init, y, nv, out, S, n_steps, st);
    case 24: return launch<24, ADD>(params, init, y, nv, out, S, n_steps, st);
    default:
      return launch_generic<ADD>(params, init, y, nv, ring, out, S, n_steps,
                                 m, st);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  `ring`
// is the (4m, S) scratch of the generic form: null for m in {4, 7, 12,
// 24}, required for any other m.  Returns the cudaError_t of the launch
// (0 on success), or -1 for bad arguments.
extern "C" int hw_sse_launch(const float* params, const float* init,
                             const float* y, const float* nv, float* ring,
                             float* out, int S, int n_steps, int m,
                             int additive, void* stream_ptr) {
  if (S <= 0 || n_steps < 1 || m < 1) return -1;
  const bool in_registers = m == 4 || m == 7 || m == 12 || m == 24;
  if (!in_registers && ring == nullptr) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(
      additive ? dispatch<true>(params, init, y, nv, ring, out, S, n_steps,
                                m, st)
               : dispatch<false>(params, init, y, nv, ring, out, S, n_steps,
                                 m, st));
}
