// Fused ARMA normal equations for the CSS Levenberg-Marquardt fit.
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

}  // namespace

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
