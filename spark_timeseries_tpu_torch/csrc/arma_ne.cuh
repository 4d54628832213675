// The device code of arma_ne_kernel (one normal-equations pass) and
// arma_lm_fit_kernel (a lane's whole CSS Levenberg-Marquardt fit), shared
// by csrc/arma_ne.cu (the C interface) and the csrc/arma_ne.orders*.cu
// files, which instantiate both kernels for their share of the orders
// p, q <= 5 (one nvcc each, all in parallel, linked into one library).
// What the kernels compute and what bounds them is in arma_ne.cu's note.
//
// Each (P, Q) is instantiated in exactly one orders file, through
// ARMA_NE_ORDER(P, Q) at the end of this header, which defines the two
// functions arma_ne.cu dispatches to: arma_ne::ne_launch_P_Q and
// arma_ne::lm_pick_P_Q.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace arma_ne {

constexpr int kMaxOrder = 5;        // p, q <= 5 are instantiated
constexpr int kThreads = 128;       // arma_ne_kernel's block
constexpr int kMaxLmThreads = 256;  // the largest LM-fit block

// The LM fit's arguments.  The panel has S_y series; a launch fits S
// lanes, lanes lane0 .. lane0 + S - 1 of a layout of S_all: lane i reads
// y column i % S_y and n_valid[i % S_y] and its own column i of x0, mask
// and the outputs (the candidate-major grid of pallas_arma.fit_css_lm;
// S == S_y == S_all, lane0 == 0 is the plain per-series fit).  x0, mask
// and x hold a padded parameter layout [c?, AR(P_pad), MA(Q_pad)], of
// which an instantiation <P, Q, ICPT> owns the intercept, the first P AR
// slots and the Q MA slots from theta_slot on (ICPT + P is the identity,
// where the layout is the instantiation's own); the CSS window starts at
// t0 >= max(P, Q) (max(P_pad, Q_pad) on a padded layout).
struct LmArgs {
  const float* x0;           // (k_pad, S_all) starting points
  const float* y;            // (n_obs, S_y)
  const float* nv;           // (S_y,) or null
  const float* mask;         // (k_pad, S_all) of 0/1, or null
  float* x;                  // out (k_pad, S_all): the owned slots
  float* fun;                // out (S_all,)
  unsigned char* converged;  // out (S_all,) bool
  int* n_iter;               // out (S_all,)
  int S, S_y, n_obs;
  float tol;
  int max_iter;
  int lane0, S_all;          // this launch's first lane; the layout's lanes
  int theta_slot;            // padded slot of theta_1
  int t0;                    // the CSS window's first step
};

using LmKernel = void (*)(const LmArgs);

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
  // time steps unrolled in the pass: fewer for the wide orders, whose
  // step is long already (it changes code size, not arithmetic)
  static constexpr int UNROLL = K >= 8 ? 2 : 4;
};

// Index of (a, b), a <= b, in the packed row-major upper triangle.
__host__ __device__ constexpr int tri(int a, int b, int k) {
  return a * k - a * (a - 1) / 2 + (b - a);
}

// One normal-equations pass of a lane at prm = [c?, phi..., theta...]
// over the window t0 <= t < n_obs (t0 >= max(P, Q)).  `y` is the lane's
// column of the time-major panel (row stride `stride`).
//
// Every product is fused into its sum with __fmaf_rn, and every other
// operation rounds on its own (__fsub_rn, __fmul_rn): left to the
// compiler, whether a product fuses depends on the instantiation (a
// pure-AR lane's y-lag products recur across unrolled steps, are computed
// once and then not fused), so the same lane fitted at <p, q> and inside
// a padded <P, Q> would round apart.  Written out, a padded instantiation
// whose extra slots are zero adds exact zeros (fma(0, v, s) == s for a
// finite v) and rounds as the lane's own order does.
template <int P, int Q, int ICPT, bool RAGGED>
__device__ __forceinline__ void ne_pass(
    const float (&prm)[Order<P, Q, ICPT>::KA], const float* __restrict__ y,
    const size_t stride, const float n_valid, const int t0, const int n_obs,
    float& sse,
    float (&jtj)[Order<P, Q, ICPT>::NTA],
    float (&jtr)[Order<P, Q, ICPT>::KA]) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K, NT = O::NT;
  constexpr int PA = O::PA, QA = O::QA, KA = O::KA;
  const float c = ICPT ? prm[0] : 0.0f;

  // rings, newest first: yr[j] = y_{t-j-1}, er[m] = e_{t-m-1}
  float yr[PA], er[QA], Tr[QA][KA];
#pragma unroll
  for (int j = 0; j < PA; ++j)
    yr[j] = j < P ? y[static_cast<size_t>(t0 - 1 - j) * stride] : 0.0f;
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

  const float* yp = y + static_cast<size_t>(t0) * stride;
#pragma unroll (O::UNROLL)
  for (int t = t0; t < n_obs; ++t, yp += stride) {
    const float yt = *yp;
    float yhat = c;
#pragma unroll
    for (int j = 0; j < P; ++j) yhat = __fmaf_rn(prm[ICPT + j], yr[j], yhat);
#pragma unroll
    for (int m = 0; m < Q; ++m)
      yhat = __fmaf_rn(prm[ICPT + P + m], er[m], yhat);
    float e = __fsub_rn(yt, yhat);
    float T[KA];
#pragma unroll
    for (int x = 0; x < K; ++x) {
      float u;
      if (x < ICPT) u = 1.0f;
      else if (x < ICPT + P) u = yr[(x - ICPT) % PA];
      else u = er[(x - ICPT - P) % QA];
      float acc = u;
#pragma unroll
      for (int m = 0; m < Q; ++m)
        acc = __fmaf_rn(prm[ICPT + P + m], Tr[m][x], acc);
      T[x] = -acc;
    }
    if (RAGGED) {
      const float w = static_cast<float>(t) < n_valid ? 1.0f : 0.0f;
      e = __fmul_rn(e, w);
#pragma unroll
      for (int x = 0; x < K; ++x) T[x] = __fmul_rn(T[x], w);
    }
    sse = __fmaf_rn(e, e, sse);
#pragma unroll
    for (int a = 0, idx = 0; a < K; ++a) {
#pragma unroll
      for (int b = a; b < K; ++b, ++idx)
        jtj[idx] = __fmaf_rn(T[a], T[b], jtj[idx]);
    }
#pragma unroll
    for (int x = 0; x < K; ++x) jtr[x] = __fmaf_rn(T[x], e, jtr[x]);
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
                              O::ML, n_obs, sse, jtj, jtr);
  out[s] = sse;
#pragma unroll
  for (int i = 0; i < O::NT; ++i) out[(1 + i) * stride + s] = jtj[i];
#pragma unroll
  for (int x = 0; x < O::K; ++x) out[(1 + O::NT + x) * stride + s] = jtr[x];
}

template <int P, int Q, int ICPT>
cudaError_t launch_ne(const float* params, const float* y, const float* nv,
                      float* out, int S, int n_obs, cudaStream_t stream) {
  if constexpr (P + Q + ICPT == 0) {
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((S + kThreads - 1) / kThreads);
    if (nv != nullptr)
      arma_ne_kernel<P, Q, ICPT, true><<<grid, kThreads, 0, stream>>>(
          params, y, nv, out, S, n_obs);
    else
      arma_ne_kernel<P, Q, ICPT, false><<<grid, kThreads, 0, stream>>>(
          params, y, nv, out, S, n_obs);
    return cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// The whole LM fit.

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
    const int t0, const int n_obs, float& sse,
    float (&jtj)[Order<P, Q, ICPT>::NTA],
    float (&jtr)[Order<P, Q, ICPT>::KA]) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K;
  float prm[O::KA];
#pragma unroll
  for (int c = 0; c < K; ++c) prm[c] = masked ? __fmul_rn(x[c], msk[c]) : x[c];
  ne_pass<P, Q, ICPT, RAGGED>(prm, y, stride, n_valid, t0, n_obs, sse, jtj,
                              jtr);
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

// One thread fits one lane, reading and writing its own slots of the
// padded layout (LmArgs); the slots it does not own are the caller's.
template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(kMaxLmThreads)
arma_lm_fit_kernel(const LmArgs A) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K, KA = O::KA, NTA = O::NTA;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= A.S) return;
  const int lane = A.lane0 + r;
  const size_t stride = static_cast<size_t>(A.S_all);
  const int col = lane % A.S_y;
  const size_t y_stride = static_cast<size_t>(A.S_y);
  const float* y = A.y + col;
  const bool masked = A.mask != nullptr;
  const float tol = A.tol;
  const float n_valid = RAGGED ? A.nv[col] : 0.0f;
  const int t0 = A.t0;
  // the offset of parameter c's row in the padded layout: the intercept
  // and AR slots keep their index, the MA slots start at theta_slot
  const size_t ma_shift =
      static_cast<size_t>(A.theta_slot - (ICPT + P)) * stride;
  auto at = [&](int c) {
    return static_cast<size_t>(c) * stride + (c < ICPT + P ? 0 : ma_shift) +
           lane;
  };

  float x[KA], msk[KA];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    x[c] = A.x0[at(c)];
    msk[c] = masked ? A.mask[at(c)] : 1.0f;
    if (masked) x[c] = __fmul_rn(x[c], msk[c]);
  }
  // the current point's sse and normal equations
  float f, jtj[NTA], jtr[KA];
  lm_pass<P, Q, ICPT, RAGGED>(x, msk, masked, y, y_stride, n_valid, t0,
                              A.n_obs, f, jtj, jtr);
  float lam = 1e-3f;
  int it = 0;
  bool conv = false;
  while (!conv && it < A.max_iter) {
    float xt[KA], dmax, ft, jtj_t[NTA], jtr_t[KA];
    lm_step<K, KA, NTA>(jtj, jtr, lam, x, xt, dmax);
    const bool ok = lm_pass<P, Q, ICPT, RAGGED>(xt, msk, masked, y, y_stride,
                                                n_valid, t0, A.n_obs, ft,
                                                jtj_t, jtr_t);
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
  for (int c = 0; c < K; ++c) A.x[at(c)] = x[c];
  A.fun[lane] = f;
  A.converged[lane] = conv ? 1 : 0;
  A.n_iter[lane] = it;
}

template <int P, int Q, int ICPT>
LmKernel pick_lm_icpt(bool ragged) {
  if constexpr (P + Q + ICPT == 0) {
    return nullptr;
  } else {
    return ragged ? &arma_lm_fit_kernel<P, Q, ICPT, true>
                  : &arma_lm_fit_kernel<P, Q, ICPT, false>;
  }
}

}  // namespace

// Defined by ARMA_NE_ORDER in the orders files, one pair per (P, Q).
#define ARMA_NE_DECLARE(P, Q)                                              \
  cudaError_t ne_launch_##P##_##Q(int icpt, const float* params,           \
                                  const float* y, const float* nv,         \
                                  float* out, int S, int n_obs,            \
                                  cudaStream_t stream);                    \
  LmKernel lm_pick_##P##_##Q(int icpt, bool ragged);

#define ARMA_NE_ORDER(P, Q)                                                \
  cudaError_t ne_launch_##P##_##Q(int icpt, const float* params,           \
                                  const float* y, const float* nv,         \
                                  float* out, int S, int n_obs,            \
                                  cudaStream_t stream) {                   \
    return icpt ? launch_ne<P, Q, 1>(params, y, nv, out, S, n_obs, stream) \
                : launch_ne<P, Q, 0>(params, y, nv, out, S, n_obs, stream);\
  }                                                                        \
  LmKernel lm_pick_##P##_##Q(int icpt, bool ragged) {                      \
    return icpt ? pick_lm_icpt<P, Q, 1>(ragged)                            \
                : pick_lm_icpt<P, Q, 0>(ragged);                           \
  }

// Every (P, Q) with p, q <= kMaxOrder: X(P, Q) for each.
#define ARMA_NE_FOR_EACH_ORDER(X)                                          \
  X(0, 0) X(0, 1) X(0, 2) X(0, 3) X(0, 4) X(0, 5)                          \
  X(1, 0) X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(1, 5)                          \
  X(2, 0) X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(2, 5)                          \
  X(3, 0) X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(3, 5)                          \
  X(4, 0) X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(4, 5)                          \
  X(5, 0) X(5, 1) X(5, 2) X(5, 3) X(5, 4) X(5, 5)

ARMA_NE_FOR_EACH_ORDER(ARMA_NE_DECLARE)

}  // namespace arma_ne
