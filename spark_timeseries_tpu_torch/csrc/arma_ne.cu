// Fused ARMA normal equations (arma_ne_kernel), the whole CSS
// Levenberg-Marquardt fit of a panel in one launch (arma_lm_fit_kernel,
// further down), and the CSS cost alone (arma_css_kernel, last).  The
// first two run the one pass below.
//
// The pass replaces the Pallas TPU kernel
// spark_timeseries_tpu/ops/pallas_arma.py::_ne_kernel and computes its
// function: per series lane, one sweep over the CSS window t >= max(p, q)
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
// The pass: one thread per lane, the whole carry (e ring, T ring, y ring,
// sse, triu, Jtr, coefficients: about 40 floats at (2,1,2) with
// intercept) in registers; templated on (P, Q, ICPT, RAGGED) so every
// inner loop unrolls.  Orders p, q <= 3 are instantiated.
//
// arma_ne_kernel, one pass.  Bound on the H100 (3.35 TB/s, 67 TFLOP/s
// fp32 outside the tensor cores) at the main path's (2,1,2), S = 131072,
// n_obs = 127: the call must read y (66.6 MB) and params (2.6 MB) and
// write out (11.0 MB), ~24 us; it does 76 flop per lane-step (yhat 8, e 1,
// T 25, sse 2, triu 30, Jtr 10) x 125 steps x 131072 lanes = 1.25 GFLOP,
// ~19 us.  So bytes bound it; each lane's step is a short dependent chain,
// and the design hides its latency with many resident warps (1024 blocks
// of 128 threads: under one wave of the 132 SMs at 2048 threads each).
//
// arma_lm_fit_kernel: per lane, the state machine of the batched LM
// loop ops/arma_ne.py::fit_css_lm_route (the port of the Pallas
// solver's fit_css_lm, spark_timeseries_tpu/ops/pallas_arma.py:463):
// normal equations at x0; then, while the lane is not done and has run
// fewer than max_iter iterations: damp = lam diag(JtJ) + 1e-12, the
// unrolled Cholesky solve of (JtJ + damp I) delta = Jtr, one pass at the
// trial x - delta, accept when its sse drops and everything it returned is
// finite (keeping the trial's JtJ, Jtr and sse), the relative-drop,
// small-step and pinned (rejected at the pre-update lam > 1e8) exits, lam
// x 0.1 or x 10.  A lane's result does not depend on the other lanes (the
// batched loop freezes finished lanes, and its iteration cap is the
// same for each), so one thread runs one lane's whole fit.  The
// arithmetic around the pass is written in the batched loop's order
// with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so no
// FMA contraction moves an accept or stop decision away from that loop
// over arma_ne_kernel.  An optional (k, S) mask of 0/1 freezes parameter
// slots, as in the loop: the pass runs at x * mask and its JtJ and Jtr
// are post-scaled.  Outputs x (k, S), fun (the sse), converged, n_iter;
// a lane ran 1 + n_iter passes.
//
// Its bound is operations: 76 flop x 125 steps per pass at (2,1,2), and a
// lane needs 1 + n_iter passes (a mean of ~13 on the main path's panel,
// at most 51), so at S = 131072 the chunk's ~1.8e6 passes are ~1.7e10
// flop, ~0.25 ms at 67 TFLOP/s; its one read of the inputs is ~0.02 ms.
// The design keeps the LM state (x, lam, f, the accepted triu(JtJ) and
// Jtr, the trial) in registers beside the pass's carry (108 registers at
// (2,1,2), 174 at (3,3,1)) and reads y from global memory on every pass:
// time-major, so a warp's loads are coalesced because its threads hold
// consecutive lanes.  A warp waits for its slowest lane (warp efficiency
// 0.28 on the main path's panel); a lane queue that handed finished
// threads further lanes lifted that to 0.44 but scattered each warp's
// loads and measured 1.4-1.7x slower (PERF.md), so each thread fits its
// own lane.

#include <cuda_runtime.h>

namespace {

template <int P, int Q, int ICPT>
struct Order {
  static constexpr int K = ICPT + P + Q;
  static constexpr int NT = K * (K + 1) / 2;
  static constexpr int ML = P > Q ? P : Q;
  // arrays of a zero size keep one unused slot (C++ has no empty arrays)
  static constexpr int PA = P > 0 ? P : 1;
  static constexpr int QA = Q > 0 ? Q : 1;
  static constexpr int KA = K > 0 ? K : 1;
  static constexpr int NTA = NT > 0 ? NT : 1;
};

// Index of (a, b), a <= b, in the packed row-major upper triangle.
__host__ __device__ constexpr int tri(int a, int b, int k) {
  return a * k - a * (a - 1) / 2 + (b - a);
}

// One normal-equations pass of a lane at prm = [c?, phi..., theta...].
// `y` is the lane's column of the time-major panel (row stride `stride`).
template <int P, int Q, int ICPT, bool RAGGED>
__device__ __forceinline__ void ne_pass(
    const float (&prm)[Order<P, Q, ICPT>::KA], const float* __restrict__ y,
    const size_t stride, const float n_valid, const int n_obs, float& sse,
    float (&jtj)[Order<P, Q, ICPT>::NTA],
    float (&jtr)[Order<P, Q, ICPT>::KA]) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K, NT = O::NT, ML = O::ML;
  constexpr int PA = O::PA, QA = O::QA, KA = O::KA;
  const float c = ICPT ? prm[0] : 0.0f;

  // rings, newest first: yr[j] = y_{t-j-1}, er[m] = e_{t-m-1}
  float yr[PA], er[QA], Tr[QA][KA];
#pragma unroll
  for (int j = 0; j < PA; ++j)
    yr[j] = j < P ? y[static_cast<size_t>(ML - 1 - j) * stride] : 0.0f;
#pragma unroll
  for (int m = 0; m < QA; ++m) {
    er[m] = 0.0f;
#pragma unroll
    for (int x = 0; x < K; ++x) Tr[m][x] = 0.0f;
  }
  sse = 0.0f;
#pragma unroll
  for (int i = 0; i < NT; ++i) jtj[i] = 0.0f;
#pragma unroll
  for (int x = 0; x < K; ++x) jtr[x] = 0.0f;

  const float* yp = y + static_cast<size_t>(ML) * stride;
#pragma unroll 4
  for (int t = ML; t < n_obs; ++t, yp += stride) {
    const float yt = *yp;
    float yhat = c;
#pragma unroll
    for (int j = 0; j < P; ++j) yhat += prm[ICPT + j] * yr[j];
#pragma unroll
    for (int m = 0; m < Q; ++m) yhat += prm[ICPT + P + m] * er[m];
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
      for (int m = 0; m < Q; ++m) acc += prm[ICPT + P + m] * Tr[m][x];
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
}

constexpr int kThreads = 128;

template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(kThreads)
arma_ne_kernel(const float* __restrict__ params, const float* __restrict__ y,
               const float* __restrict__ nv, float* __restrict__ out,
               int S, int n_obs) {
  using O = Order<P, Q, ICPT>;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t stride = static_cast<size_t>(S);
  float prm[O::KA], sse, jtj[O::NTA], jtr[O::KA];
#pragma unroll
  for (int x = 0; x < O::K; ++x) prm[x] = params[x * stride + s];
  ne_pass<P, Q, ICPT, RAGGED>(prm, y + s, stride, RAGGED ? nv[s] : 0.0f,
                              n_obs, sse, jtj, jtr);
  out[s] = sse;
#pragma unroll
  for (int i = 0; i < O::NT; ++i) out[(1 + i) * stride + s] = jtj[i];
#pragma unroll
  for (int x = 0; x < O::K; ++x) out[(1 + O::NT + x) * stride + s] = jtr[x];
}

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

// ---------------------------------------------------------------------------
// The whole LM fit.

constexpr int kMaxLmThreads = 256;

struct LmArgs {
  const float* x0;           // (k, S) starting points
  const float* y;            // (n_obs, S)
  const float* nv;           // (S,) or null
  const float* mask;         // (k, S) of 0/1, or null
  float* x;                  // out (k, S)
  float* fun;                // out (S,)
  unsigned char* converged;  // out (S,) bool
  int* n_iter;               // out (S,)
  int S, n_obs;
  float tol;
  int max_iter;
};

// max over |v| that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float m, float v) {
  return (isnan(v) || v > m) ? v : m;
}

// One LM step of a lane: the trial xt = x - delta of the damped normal
// equations, as ops/linalg.py::spd_solve computes it (each s - a * b a
// rounded product then a rounded difference); dmax = max |delta|.
template <int K, int KA, int NTA>
__device__ __forceinline__ void lm_step(const float (&jtj)[NTA],
                                        const float (&jtr)[KA],
                                        const float lam, const float (&x)[KA],
                                        float (&xt)[KA], float& dmax) {
  float damp[KA], L[KA][KA], z[KA], delta[KA];
#pragma unroll
  for (int i = 0; i < K; ++i)
    damp[i] = __fadd_rn(__fmul_rn(lam, jtj[tri(i, i, K)]), 1e-12f);
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      // (JtJ + damp[..., None] * eye)[i][j]: an inf damp makes the
      // off-diagonal entries inf * 0 = NaN there too
      float s = __fadd_rn(jtj[tri(j, i, K)],
                          __fmul_rn(damp[i], i == j ? 1.0f : 0.0f));
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(s) : __fdiv_rn(s, L[j][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = jtr[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], z[k]));
    z[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int k = i + 1; k < K; ++k)
      s = __fsub_rn(s, __fmul_rn(L[k][i], delta[k]));
    delta[i] = __fdiv_rn(s, L[i][i]);
  }
  dmax = fabsf(delta[0]);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    xt[i] = __fsub_rn(x[i], delta[i]);
    dmax = nan_max(dmax, fabsf(delta[i]));
  }
}

// One normal-equations pass at x * msk (when masked) with its JtJ and Jtr
// post-scaled, as the batched loop's ne(); returns whether JtJ and Jtr
// are finite.
template <int P, int Q, int ICPT, bool RAGGED>
__device__ __forceinline__ bool lm_pass(
    const float (&x)[Order<P, Q, ICPT>::KA],
    const float (&msk)[Order<P, Q, ICPT>::KA], const bool masked,
    const float* __restrict__ y, const size_t stride, const float n_valid,
    const int n_obs, float& sse, float (&jtj)[Order<P, Q, ICPT>::NTA],
    float (&jtr)[Order<P, Q, ICPT>::KA]) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K;
  float prm[O::KA];
#pragma unroll
  for (int c = 0; c < K; ++c) prm[c] = masked ? __fmul_rn(x[c], msk[c]) : x[c];
  ne_pass<P, Q, ICPT, RAGGED>(prm, y, stride, n_valid, n_obs, sse, jtj, jtr);
  if (masked) {
    // the loop's jtj * mask[:, :, None] * mask[:, None, :]: entry [i][j]
    // scaled by mask[i] then mask[j]; the solve reads i >= j
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = a; b < K; ++b)
        jtj[tri(a, b, K)] =
            __fmul_rn(__fmul_rn(jtj[tri(a, b, K)], msk[b]), msk[a]);
      jtr[a] = __fmul_rn(jtr[a], msk[a]);
    }
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < O::NT; ++i) ok = ok && isfinite(jtj[i]);
#pragma unroll
  for (int c = 0; c < K; ++c) ok = ok && isfinite(jtr[c]);
  return ok;
}

// One thread fits one lane.
template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(kMaxLmThreads)
arma_lm_fit_kernel(const LmArgs A) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K, KA = O::KA, NTA = O::NTA;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= A.S) return;
  const size_t stride = static_cast<size_t>(A.S);
  const float* y = A.y + lane;
  const bool masked = A.mask != nullptr;
  const float tol = A.tol;
  const float n_valid = RAGGED ? A.nv[lane] : 0.0f;

  float x[KA], msk[KA];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    x[c] = A.x0[c * stride + lane];
    msk[c] = masked ? A.mask[c * stride + lane] : 1.0f;
    if (masked) x[c] = __fmul_rn(x[c], msk[c]);
  }
  // the current point's sse and normal equations
  float f, jtj[NTA], jtr[KA];
  lm_pass<P, Q, ICPT, RAGGED>(x, msk, masked, y, stride, n_valid, A.n_obs, f,
                              jtj, jtr);
  float lam = 1e-3f;
  int it = 0;
  bool conv = false;
  while (!conv && it < A.max_iter) {
    float xt[KA], dmax, ft, jtj_t[NTA], jtr_t[KA];
    lm_step<K, KA, NTA>(jtj, jtr, lam, x, xt, dmax);
    const bool ok = lm_pass<P, Q, ICPT, RAGGED>(xt, msk, masked, y, stride,
                                                n_valid, A.n_obs, ft, jtj_t,
                                                jtr_t);
    const bool improved = ft < f && isfinite(ft) && ok;
    if (improved) {
#pragma unroll
      for (int c = 0; c < K; ++c) x[c] = xt[c];
#pragma unroll
      for (int i = 0; i < O::NT; ++i) jtj[i] = jtj_t[i];
#pragma unroll
      for (int c = 0; c < K; ++c) jtr[c] = jtr_t[c];
    }
    // the exits test the pre-update f and lam, and the updated x
    const bool rel_drop =
        __fsub_rn(f, ft) <= __fmul_rn(tol, __fadd_rn(fabsf(f), tol));
    float xmax = fabsf(x[0]);
#pragma unroll
    for (int c = 0; c < K; ++c) xmax = nan_max(xmax, fabsf(x[c]));
    const bool step_small = dmax <= __fmul_rn(tol, __fadd_rn(xmax, tol));
    conv = (improved && (rel_drop || step_small)) ||
           (!improved && lam > 1e8f);
    lam = improved ? __fmul_rn(lam, 0.1f) : __fmul_rn(lam, 10.0f);
    if (improved) f = ft;
    ++it;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) A.x[c * stride + lane] = x[c];
  A.fun[lane] = f;
  A.converged[lane] = conv ? 1 : 0;
  A.n_iter[lane] = it;
}

using LmKernel = void (*)(const LmArgs);

template <int P, int Q>
LmKernel pick_lm_pq(int icpt, bool ragged) {
  if (icpt)
    return ragged ? &arma_lm_fit_kernel<P, Q, 1, true>
                  : &arma_lm_fit_kernel<P, Q, 1, false>;
  return ragged ? &arma_lm_fit_kernel<P, Q, 0, true>
                : &arma_lm_fit_kernel<P, Q, 0, false>;
}

LmKernel pick_lm(int p, int q, int icpt, bool ragged) {
#define ARMA_LM_CASE(PP, QQ) \
  if (p == PP && q == QQ) return pick_lm_pq<PP, QQ>(icpt, ragged);
  ARMA_LM_CASE(0, 0) ARMA_LM_CASE(0, 1) ARMA_LM_CASE(0, 2) ARMA_LM_CASE(0, 3)
  ARMA_LM_CASE(1, 0) ARMA_LM_CASE(1, 1) ARMA_LM_CASE(1, 2) ARMA_LM_CASE(1, 3)
  ARMA_LM_CASE(2, 0) ARMA_LM_CASE(2, 1) ARMA_LM_CASE(2, 2) ARMA_LM_CASE(2, 3)
  ARMA_LM_CASE(3, 0) ARMA_LM_CASE(3, 1) ARMA_LM_CASE(3, 2) ARMA_LM_CASE(3, 3)
#undef ARMA_LM_CASE
  return nullptr;
}

// The launch configuration: the kernel, its grid (a thread for every
// lane), its residency and its registers.
struct LmConfig {
  LmKernel kernel;
  int blocks, blocks_per_sm, sms, registers, local_bytes;
};

bool lm_args_ok(int S, int n_obs, int p, int q, int icpt, int threads) {
  return S > 0 && p >= 0 && q >= 0 && p + q + icpt > 0 &&
         n_obs > (p > q ? p : q) && threads >= 32 &&
         threads <= kMaxLmThreads && threads % 32 == 0;
}

cudaError_t lm_config(int S, int p, int q, int icpt, bool ragged, int threads,
                      LmConfig* cfg) {
  cfg->kernel = pick_lm(p, q, icpt, ragged);
  if (cfg->kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cfg->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(cfg->kernel);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cfg->blocks_per_sm, fn,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  cfg->registers = attr.numRegs;
  cfg->local_bytes = static_cast<int>(attr.localSizeBytes);
  cfg->blocks = (S + threads - 1) / threads;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The CSS cost alone: the port of the cost-only mode of the Pallas kernel
// docs/experiments/arma_pallas.py::_css_kernel (with_grad=False), whose
// gradient mode is the pass above on a dense panel.  Per lane,
// sse = sum_{t >= max(p, q)} e_t^2 with the recurrence above and only the
// e ring carried; ragged lanes weight e by (t < nv) before the
// accumulator and the ring push, as above.  Q (<= 5, the auto-fit grid's
// largest MA order) is static, and so is P for p <= 5 (kCssStaticP): the
// coefficients, the e ring and the y-lag ring stay in registers, as in
// the pass, and each step loads y_t alone.  A larger p (P = -1) runs the
// runtime form, whose AR terms read their y lags and coefficients where
// they lie (lines the warp loaded in the last p steps, so L1 hits), which
// lets the AR fast path of any order score itself on the card.
// Output (1, S).  Bound at (2,1,2) with intercept, S = 131072,
// n_obs = 127: reading y and params and writing sse moves 69.7 MB, ~21 us;
// 11 flop per lane-step (yhat 8, e 1, sse 2) are 0.18 GFLOP, ~3 us: bytes.

constexpr int kCssStaticP = 5;

template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(kThreads)
arma_css_kernel(const float* __restrict__ params, const float* __restrict__ y,
                const float* __restrict__ nv, float* __restrict__ out, int S,
                int n_obs, int p) {
  constexpr int QA = Q > 0 ? Q : 1;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const size_t stride = static_cast<size_t>(S);
  const float c = ICPT ? params[s] : 0.0f;
  const float n_valid = RAGGED ? nv[s] : 0.0f;
  float sse = 0.0f;
  if constexpr (P >= 0) {
    using O = Order<P, Q, ICPT>;
    constexpr int PA = O::PA, ML = O::ML;
    float phi[PA], yr[PA], theta[QA], er[QA];
#pragma unroll
    for (int j = 0; j < PA; ++j) {
      phi[j] = j < P ? params[(ICPT + j) * stride + s] : 0.0f;
      yr[j] = j < P ? y[static_cast<size_t>(ML - 1 - j) * stride + s] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < QA; ++m) {
      theta[m] = m < Q ? params[(ICPT + P + m) * stride + s] : 0.0f;
      er[m] = 0.0f;
    }
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
      if (RAGGED) e *= static_cast<float>(t) < n_valid ? 1.0f : 0.0f;
      sse += e * e;
      if (Q > 0) {
#pragma unroll
        for (int m = QA - 1; m > 0; --m) er[m] = er[m - 1];
        er[0] = e;
      }
      if (P > 0) {
#pragma unroll
        for (int j = PA - 1; j > 0; --j) yr[j] = yr[j - 1];
        yr[0] = yt;
      }
    }
  } else {
    const int ml = p > Q ? p : Q;
    const float* phi = params + static_cast<size_t>(ICPT) * stride + s;
    float theta[QA], er[QA];
#pragma unroll
    for (int m = 0; m < QA; ++m) {
      theta[m] = m < Q ? params[(ICPT + p + m) * stride + s] : 0.0f;
      er[m] = 0.0f;
    }
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
  }
  out[s] = sse;
}

template <int P, int Q, int ICPT>
cudaError_t launch_css(const float* params, const float* y, const float* nv,
                       float* out, int S, int n_obs, int p,
                       cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    arma_css_kernel<P, Q, ICPT, true><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs, p);
  else
    arma_css_kernel<P, Q, ICPT, false><<<grid, kThreads, 0, stream>>>(
        params, y, nv, out, S, n_obs, p);
  return cudaGetLastError();
}

template <int P, int Q>
cudaError_t launch_css_icpt(int icpt, const float* params, const float* y,
                            const float* nv, float* out, int S, int n_obs,
                            int p, cudaStream_t stream) {
  return icpt ? launch_css<P, Q, 1>(params, y, nv, out, S, n_obs, p, stream)
              : launch_css<P, Q, 0>(params, y, nv, out, S, n_obs, p, stream);
}

template <int Q>
cudaError_t launch_css_p(int icpt, const float* params, const float* y,
                         const float* nv, float* out, int S, int n_obs, int p,
                         cudaStream_t st) {
  static_assert(kCssStaticP == 5, "the cases below instantiate p <= 5");
  switch (p) {
    case 0: return launch_css_icpt<0, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 1: return launch_css_icpt<1, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 2: return launch_css_icpt<2, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 3: return launch_css_icpt<3, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 4: return launch_css_icpt<4, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 5: return launch_css_icpt<5, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
    default: return launch_css_icpt<-1, Q>(icpt, params, y, nv, out, S, n_obs, p, st);
  }
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
    case 0: return launch_css_p<0>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 1: return launch_css_p<1>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 2: return launch_css_p<2>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 3: return launch_css_p<3>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 4: return launch_css_p<4>(icpt, params, y, nv, out, S, n_obs, p, st);
    case 5: return launch_css_p<5>(icpt, params, y, nv, out, S, n_obs, p, st);
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

// The LM fit's launch configuration for `threads` a block into cfg[0..4]
// = (blocks, resident blocks per SM, SMs, registers a thread, local
// (spill) bytes a thread).  Returns 0, a cudaError_t, or -1 for bad
// arguments or a block that cannot be resident.
extern "C" int arma_lm_fit_config(int S, int n_obs, int p, int q, int icpt,
                                  int ragged, int threads, int* cfg) {
  if (!lm_args_ok(S, n_obs, p, q, icpt, threads)) return -1;
  LmConfig c;
  const cudaError_t err =
      lm_config(S, p, q, icpt, ragged != 0, threads, &c);
  if (err == cudaErrorInvalidValue && c.kernel == nullptr) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.blocks_per_sm < 1) return -1;
  cfg[0] = c.blocks;
  cfg[1] = c.blocks_per_sm;
  cfg[2] = c.sms;
  cfg[3] = c.registers;
  cfg[4] = c.local_bytes;
  return 0;
}

// Launches the whole LM fit of S lanes on `stream`; does not synchronise,
// allocates nothing.  x0 (k, S), y (n_obs, S), nv (S,) or null, mask
// (k, S) or null; outputs x (k, S), fun, converged, n_iter (S,), one
// thread a lane in blocks of `threads`.  Returns 0, a cudaError_t, or -1
// for bad arguments.
extern "C" int arma_lm_fit_launch(
    const float* x0, const float* y, const float* nv, const float* mask,
    float* x, float* fun, unsigned char* converged, int* n_iter, int S,
    int n_obs, int p, int q, int icpt, float tol, int max_iter, int threads,
    void* stream_ptr) {
  if (!lm_args_ok(S, n_obs, p, q, icpt, threads)) return -1;
  LmConfig c;
  cudaError_t err = lm_config(S, p, q, icpt, nv != nullptr, threads, &c);
  if (err == cudaErrorInvalidValue && c.kernel == nullptr) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.blocks_per_sm < 1) return -1;
  LmArgs args{x0, y, nv, mask, x, fun, converged, n_iter, S, n_obs, tol,
              max_iter};
  void* kernel_args[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(c.kernel),
                         dim3(c.blocks), dim3(threads), kernel_args, 0,
                         static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
