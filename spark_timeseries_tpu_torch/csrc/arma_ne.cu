// Fused ARMA normal equations for the CSS Levenberg-Marquardt fit, and
// (arma_css_kernel, further down) the CSS cost alone.
//
// Replaces the Pallas TPU kernel
// spark_timeseries_tpu/ops/pallas_arma.py::_ne_kernel and computes its
// function: per series lane, one pass over the CSS window t >= max(p, q)
// with zero rings, accumulating
//
//   e_t  = y_t - c - sum_j phi_j y_{t-j-1} - sum_m theta_m e_{t-m-1}
//   T_t  = -u_t - sum_m theta_m T_{t-m-1},   u = (1?, y lags, e lags)
//   sse += e^2,  triu(JtJ) += T T^T,  Jtr += T e
//
// Ragged lanes weight e and T by (t < nv) BEFORE the accumulators and the
// ring pushes (so the zero tail never contributes and results equal the
// trimmed series'); the y-lag ring takes the unweighted y_t.
//
// Layout (time-major, so a warp's loads at step t are 32 consecutive
// floats): params (k, S), y (n_obs, S), nv (S,) or null, out (n_out, S)
// with n_out = 1 + k(k+1)/2 + k laid out [sse, triu(JtJ)..., Jtr...].
// All float32.
//
// Design: one thread per lane, the whole carry (e ring, T ring, y ring,
// sse, triu, Jtr, coefficients: about 40 floats at (2,1,2) with
// intercept) in registers; templated on (P, Q, ICPT, RAGGED) so every
// inner loop unrolls.  Orders p, q <= 3 are instantiated.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores) at the main path's (2,1,2), S = 131072, n_obs = 127: the call
// must read y (66.6 MB) and params (2.6 MB) and write out (11.0 MB),
// ~24 us; it does 76 flop per lane-step (yhat 8, e 1, T 25, sse 2,
// triu 30, Jtr 10) x 125 steps x 131072 lanes = 1.25 GFLOP, ~19 us.
// So bytes bound it; each lane's step is a short dependent chain, and
// the design hides its latency with many resident warps (1024 blocks of
// 128 threads: under one wave of the 132 SMs at 2048 threads each).

#include <cuda_runtime.h>

namespace {

template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(128)
arma_ne_kernel(const float* __restrict__ params, const float* __restrict__ y,
               const float* __restrict__ nv, float* __restrict__ out,
               int S, int n_obs) {
  constexpr int K = ICPT + P + Q;
  constexpr int NT = K * (K + 1) / 2;
  constexpr int ML = P > Q ? P : Q;
  // arrays of a zero size keep one unused slot (C++ has no empty arrays)
  constexpr int PA = P > 0 ? P : 1;
  constexpr int QA = Q > 0 ? Q : 1;
  constexpr int KA = K > 0 ? K : 1;
  constexpr int NTA = NT > 0 ? NT : 1;

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t stride = static_cast<size_t>(S);

  const float c = ICPT ? params[s] : 0.0f;
  float phi[PA], theta[QA];
#pragma unroll
  for (int j = 0; j < P; ++j) phi[j] = params[(ICPT + j) * stride + s];
#pragma unroll
  for (int m = 0; m < Q; ++m) theta[m] = params[(ICPT + P + m) * stride + s];

  // rings, newest first: yr[j] = y_{t-j-1}, er[m] = e_{t-m-1}
  float yr[PA], er[QA], Tr[QA][KA];
#pragma unroll
  for (int j = 0; j < PA; ++j)
    yr[j] = j < P ? y[static_cast<size_t>(ML - 1 - j) * stride + s] : 0.0f;
#pragma unroll
  for (int m = 0; m < QA; ++m) {
    er[m] = 0.0f;
#pragma unroll
    for (int x = 0; x < K; ++x) Tr[m][x] = 0.0f;
  }
  float sse = 0.0f, jtj[NTA], jtr[KA];
#pragma unroll
  for (int i = 0; i < NT; ++i) jtj[i] = 0.0f;
#pragma unroll
  for (int x = 0; x < K; ++x) jtr[x] = 0.0f;
  const float n_valid = RAGGED ? nv[s] : 0.0f;

  const float* yp = y + static_cast<size_t>(ML) * stride + s;
#pragma unroll 4
  for (int t = ML; t < n_obs; ++t, yp += stride) {
    const float yt = *yp;
    float yhat = c;
#pragma unroll
    for (int j = 0; j < P; ++j) yhat += phi[j] * yr[j];
#pragma unroll
    for (int m = 0; m < Q; ++m) yhat += theta[m] * er[m];
    float e = yt - yhat;
    float T[KA];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      float u;
      if (x < ICPT) u = 1.0f;
      else if (x < ICPT + P) u = yr[(x - ICPT) % PA];
      else u = er[(x - ICPT - P) % QA];
      float acc = u;
#pragma unroll
      for (int m = 0; m < Q; ++m) acc += theta[m] * Tr[m][x];
      T[x] = -acc;
    }
    if (RAGGED) {
      const float w = static_cast<float>(t) < n_valid ? 1.0f : 0.0f;
      e *= w;
#pragma unroll
      for (int x = 0; x < K; ++x) T[x] *= w;
    }
    sse += e * e;
#pragma unroll
    for (int a = 0, idx = 0; a < K; ++a) {
#pragma unroll
      for (int b = a; b < K; ++b, ++idx) jtj[idx] += T[a] * T[b];
    }
#pragma unroll
    for (int x = 0; x < K; ++x) jtr[x] += T[x] * e;
    if (Q > 0) {
#pragma unroll
      for (int m = QA - 1; m > 0; --m) {
        er[m] = er[m - 1];
#pragma unroll
        for (int x = 0; x < K; ++x) Tr[m][x] = Tr[m - 1][x];
      }
      er[0] = e;
#pragma unroll
      for (int x = 0; x < K; ++x) Tr[0][x] = T[x];
    }
    if (P > 0) {
#pragma unroll
      for (int j = PA - 1; j > 0; --j) yr[j] = yr[j - 1];
      yr[0] = yt;
    }
  }

  out[s] = sse;
#pragma unroll
  for (int i = 0; i < NT; ++i) out[(1 + i) * stride + s] = jtj[i];
#pragma unroll
  for (int x = 0; x < K; ++x) out[(1 + NT + x) * stride + s] = jtr[x];
}

constexpr int kThreads = 128;

template <int P, int Q, int ICPT>
cudaError_t launch(const float* params, const float* y, const float* nv,
                   float* out, int S, int n_obs, cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    arma_ne_kernel<P, Q, ICPT, true><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs);
  else
    arma_ne_kernel<P, Q, ICPT, false><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs);
  return cudaGetLastError();
}

template <int P, int Q>
cudaError_t launch_icpt(int icpt, const float* params, const float* y,
                        const float* nv, float* out, int S, int n_obs,
                        cudaStream_t stream) {
  return icpt ? launch<P, Q, 1>(params, y, nv, out, S, n_obs, stream)
              : launch<P, Q, 0>(params, y, nv, out, S, n_obs, stream);
}

// The CSS cost alone: the port of the cost-only mode of the Pallas kernel
// docs/experiments/arma_pallas.py::_css_kernel (with_grad=False), whose
// gradient mode is the kernel above on a dense panel.  Per lane,
// sse = sum_{t >= max(p, q)} e_t^2 with the recurrence above and only the
// e ring carried; ragged lanes weight e by (t < nv) before the
// accumulator and the ring push, as above.  Q (<= 5, the auto-fit grid's
// largest MA order) is static so the e ring stays in registers; p is a
// runtime argument and the AR terms read their y lags and coefficients
// where they lie (lines the warp loaded in the last p steps, so L1 hits),
// which lets the AR fast path of any order score itself on the card.
// Output (1, S).  Bound at (2,1,2) with intercept, S = 131072,
// n_obs = 127: reading y and params and writing sse moves 69.7 MB, ~21 us;
// 11 flop per lane-step (yhat 8, e 1, sse 2) are 0.18 GFLOP, ~3 us: bytes.
template <int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(128)
arma_css_kernel(const float* __restrict__ params, const float* __restrict__ y,
                const float* __restrict__ nv, float* __restrict__ out, int S,
                int n_obs, int p) {
  constexpr int QA = Q > 0 ? Q : 1;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t stride = static_cast<size_t>(S);
  const int ml = p > Q ? p : Q;
  const float c = ICPT ? params[s] : 0.0f;
  const float* phi = params + static_cast<size_t>(ICPT) * stride + s;
  float theta[QA], er[QA];
#pragma unroll
  for (int m = 0; m < QA; ++m) {
    theta[m] = m < Q ? params[(ICPT + p + m) * stride + s] : 0.0f;
    er[m] = 0.0f;
  }
  const float n_valid = RAGGED ? nv[s] : 0.0f;
  float sse = 0.0f;
  for (int t = ml; t < n_obs; ++t) {
    float yhat = c;
    for (int j = 0; j < p; ++j)
      yhat += phi[j * stride] * y[static_cast<size_t>(t - j - 1) * stride + s];
#pragma unroll
    for (int m = 0; m < Q; ++m) yhat += theta[m] * er[m];
    float e = y[static_cast<size_t>(t) * stride + s] - yhat;
    if (RAGGED) e *= static_cast<float>(t) < n_valid ? 1.0f : 0.0f;
    sse += e * e;
    if (Q > 0) {
#pragma unroll
      for (int m = QA - 1; m > 0; --m) er[m] = er[m - 1];
      er[0] = e;
    }
  }
  out[s] = sse;
}

template <int Q, int ICPT>
cudaError_t launch_css(const float* params, const float* y, const float* nv,
                       float* out, int S, int n_obs, int p,
                       cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    arma_css_kernel<Q, ICPT, true><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs, p);
  else
    arma_css_kernel<Q, ICPT, false><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs, p);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_css_icpt(int icpt, const float* params, const float* y,
                            const float* nv, float* out, int S, int n_obs,
                            int p, cudaStream_t stream) {
  return icpt ? launch_css<Q, 1>(params, y, nv, out, S, n_obs, p, stream)
              : launch_css<Q, 0>(params, y, nv, out, S, n_obs, p, stream);
}

}  // namespace

// The cost-only kernel: as arma_ne_launch, for any p >= 0 and q <= 5;
// `out` is (1, S).
extern "C" int arma_css_launch(const float* params, const float* y,
                               const float* nv, float* out, int S, int n_obs,
                               int p, int q, int icpt, void* stream_ptr) {
  if (S <= 0 || p < 0 || n_obs <= (p > q ? p : q) || p + q + icpt == 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (q) {
    case 0: return launch_css_icpt<0>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 1: return launch_css_icpt<1>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 2: return launch_css_icpt<2>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 3: return launch_css_icpt<3>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 4: return launch_css_icpt<4>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 5: return launch_css_icpt<5>(icpt, params, y, nv, out, S, n_obs, p, st);
    default: return -1;
  }
}

// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// the cudaError_t of the launch (0 on success), or -1 for an order
// outside p, q <= 3 / k == 0 or a bad shape.
extern "C" int arma_ne_launch(const float* params, const float* y,
                              const float* nv, float* out, int S, int n_obs,
                              int p, int q, int icpt, void* stream_ptr) {
  if (S <= 0 || n_obs <= (p > q ? p : q) || p + q + icpt == 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define ARMA_NE_CASE(PP, QQ)                                               \
  if (p == PP && q == QQ)                                                  \
    return static_cast<int>(                                               \
        launch_icpt<PP, QQ>(icpt, params, y, nv, out, S, n_obs, st));
  ARMA_NE_CASE(0, 0) ARMA_NE_CASE(0, 1) ARMA_NE_CASE(0, 2) ARMA_NE_CASE(0, 3)
  ARMA_NE_CASE(1, 0) ARMA_NE_CASE(1, 1) ARMA_NE_CASE(1, 2) ARMA_NE_CASE(1, 3)
  ARMA_NE_CASE(2, 0) ARMA_NE_CASE(2, 1) ARMA_NE_CASE(2, 2) ARMA_NE_CASE(2, 3)
  ARMA_NE_CASE(3, 0) ARMA_NE_CASE(3, 1) ARMA_NE_CASE(3, 2) ARMA_NE_CASE(3, 3)
#undef ARMA_NE_CASE
  return -1;
}
