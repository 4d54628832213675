// The CSS cost alone over the series-major panel (arma_css_rows_kernel):
// the port of the cost-only mode of the Pallas kernel
// docs/experiments/arma_pallas.py::_css_kernel (with_grad=False), whose
// gradient mode is the normal-equations pass of arma_ne.cuh.  Per lane,
// sse = sum_{t >= max(p, q)} e_t^2 with
//
//   e_t = y_t - c - sum_j phi_j y_{t-j-1} - sum_m theta_m e_{t-m-1},
//
// only the e ring carried; ragged lanes weight e by (t < nv) before the
// accumulator and the ring push.  Operands as the callers hold them:
// params (S, k), y (S, n_obs), nv (S,) or null; output sse (S,), so a
// css_cost call launches this kernel and nothing else.
//
// A block of 32-128 consecutive lanes, one thread a lane, reads its rows
// of y through shared memory (stage_rows.cuh; the block's lane count
// from S, as for the normal equations), or from global memory where a
// row is too long to stage whole.  Q (<= 5, the auto-fit grid's largest
// MA order) is static, and so is P for p <= 5 (kCssStaticP): the
// coefficients, the e ring and the y-lag ring stay in registers, and each
// step reads y_t alone from the row.  A larger p (P = -1) runs the
// runtime form, whose AR terms read their y lags from the row and their
// coefficients from global memory (L1 hits), which lets the AR fast path
// of any order score itself on the card.
//
// Each step is written with explicit __fmaf_rn / __fsub_rn / __fmul_rn in
// the order of arma_css_kernel's source (arma_ne.cu), where nvcc fuses
// every product into its sum, so each lane's sse equals that kernel's bit
// for bit.
//
// Bound at (2,1,2) with intercept, S = 131072, n_obs = 127: reading y and
// params and writing sse moves 69.7 MB, ~21 us; 11 flop per lane-step
// (yhat 8, e 1, sse 2) are 0.18 GFLOP, ~3 us: bytes.  On the card
// (PERF.md §6) the staged pass takes ~1.2x the time-major pass's device
// time at that width (the residency of whole-row tiles, as in
// arma_ne.cu's note) and less than it at the widths the paths give it.

#include "arma_ne_rows.cuh"

namespace arma_ne {
namespace {

// One lane's cost over its row (row[t] = y_t, in shared or global
// memory) at prm = [c?, phi..., theta...], p the AR order.
template <int P, int Q, int ICPT, bool RAGGED>
__device__ __forceinline__ float css_pass(const float* __restrict__ row,
                                          const float* __restrict__ prm,
                                          const int p, const float n_valid,
                                          const int n_obs) {
  constexpr int QA = Q > 0 ? Q : 1;
  const float c = ICPT ? prm[0] : 0.0f;
  float sse = 0.0f;
  float theta[QA], er[QA];
#pragma unroll
  for (int m = 0; m < QA; ++m) {
    theta[m] = m < Q ? prm[ICPT + p + m] : 0.0f;
    er[m] = 0.0f;
  }
  if constexpr (P >= 0) {
    using O = Order<P, Q, ICPT>;
    constexpr int PA = O::PA, ML = O::ML;
    float phi[PA], yr[PA];
#pragma unroll
    for (int j = 0; j < PA; ++j) {
      phi[j] = j < P ? prm[ICPT + j] : 0.0f;
      yr[j] = j < P ? row[ML - 1 - j] : 0.0f;
    }
#pragma unroll 4
    for (int t = ML; t < n_obs; ++t) {
      const float yt = row[t];
      float yhat = c;
#pragma unroll
      for (int j = 0; j < P; ++j) yhat = __fmaf_rn(phi[j], yr[j], yhat);
#pragma unroll
      for (int m = 0; m < Q; ++m) yhat = __fmaf_rn(theta[m], er[m], yhat);
      float e = __fsub_rn(yt, yhat);
      if (RAGGED)
        e = __fmul_rn(e, static_cast<float>(t) < n_valid ? 1.0f : 0.0f);
      sse = __fmaf_rn(e, e, sse);
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
    const float* phi = prm + ICPT;
    for (int t = ml; t < n_obs; ++t) {
      float yhat = c;
      for (int j = 0; j < p; ++j)
        yhat = __fmaf_rn(phi[j], row[t - j - 1], yhat);
#pragma unroll
      for (int m = 0; m < Q; ++m) yhat = __fmaf_rn(theta[m], er[m], yhat);
      float e = __fsub_rn(row[t], yhat);
      if (RAGGED)
        e = __fmul_rn(e, static_cast<float>(t) < n_valid ? 1.0f : 0.0f);
      sse = __fmaf_rn(e, e, sse);
      if (Q > 0) {
#pragma unroll
        for (int m = QA - 1; m > 0; --m) er[m] = er[m - 1];
        er[0] = e;
      }
    }
  }
  return sse;
}

template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(stage_rows::kMaxLanes)
arma_css_rows_kernel(const RowsArgs A, const stage_rows::Tile tl) {
  extern __shared__ float smem[];
  const int r = threadIdx.x;
  const size_t s0 = static_cast<size_t>(blockIdx.x) * tl.lanes;
  const int left = A.S - static_cast<int>(s0);
  const int rows = left < tl.lanes ? left : tl.lanes;
  const bool live = r < rows;
  const size_t s = s0 + r;
  const int p = P >= 0 ? P : A.p;
  const float* prm = A.params + s * (ICPT + p + Q);
  const float n_valid = RAGGED && live ? A.nv[s] : 0.0f;
  if (tl.staged) {
    stage_rows::stage(A.y + s0 * A.n_obs, rows, A.n_obs, tl, smem);
    if (live)
      A.sse[s] = css_pass<P, Q, ICPT, RAGGED>(smem + r * tl.pitch, prm, p,
                                              n_valid, A.n_obs);
  } else if (live) {
    A.sse[s] = css_pass<P, Q, ICPT, RAGGED>(A.y + s * A.n_obs, prm, p,
                                            n_valid, A.n_obs);
  }
}

template <int P, int Q, int ICPT>
cudaError_t launch_css_rows(const RowsArgs& A, const stage_rows::Tile& tl,
                            cudaStream_t stream) {
  cudaError_t err;
  if (A.nv != nullptr) {
    err = stage_rows::allow_smem<&arma_css_rows_kernel<P, Q, ICPT, true>>(
        tl.smem);
    if (err == cudaSuccess)
      arma_css_rows_kernel<P, Q, ICPT, true>
          <<<tl.blocks, tl.lanes, tl.smem, stream>>>(A, tl);
  } else {
    err = stage_rows::allow_smem<&arma_css_rows_kernel<P, Q, ICPT, false>>(
        tl.smem);
    if (err == cudaSuccess)
      arma_css_rows_kernel<P, Q, ICPT, false>
          <<<tl.blocks, tl.lanes, tl.smem, stream>>>(A, tl);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int P, int Q>
cudaError_t launch_css_rows_icpt(int icpt, const RowsArgs& A,
                                 const stage_rows::Tile& tl,
                                 cudaStream_t st) {
  return icpt ? launch_css_rows<P, Q, 1>(A, tl, st)
              : launch_css_rows<P, Q, 0>(A, tl, st);
}

template <int Q>
cudaError_t launch_css_rows_p(int icpt, int p, const RowsArgs& A,
                              const stage_rows::Tile& tl, cudaStream_t st) {
  static_assert(kCssStaticP == 5, "the cases below instantiate p <= 5");
  switch (p) {
    case 0: return launch_css_rows_icpt<0, Q>(icpt, A, tl, st);
    case 1: return launch_css_rows_icpt<1, Q>(icpt, A, tl, st);
    case 2: return launch_css_rows_icpt<2, Q>(icpt, A, tl, st);
    case 3: return launch_css_rows_icpt<3, Q>(icpt, A, tl, st);
    case 4: return launch_css_rows_icpt<4, Q>(icpt, A, tl, st);
    case 5: return launch_css_rows_icpt<5, Q>(icpt, A, tl, st);
    default: return launch_css_rows_icpt<-1, Q>(icpt, A, tl, st);
  }
}

}  // namespace
}  // namespace arma_ne

// The series-major cost pass of S lanes on `stream`: params (S, k), y
// (S, n_obs), nv (S,) or null; writes sse (S,).  Any p >= 0, q <= 5;
// lanes 0 picks the tile (arma_rows_tile with cost_only).  Does
// not synchronise, allocates nothing.  Returns the cudaError_t of the
// launch (0 on success), or -1 for an order or shape it does not take or
// a tile no launch serves.
extern "C" int arma_css_rows_launch(const float* params, const float* y,
                                    const float* nv, float* sse, int S,
                                    int n_obs, int p, int q, int icpt,
                                    int lanes, void* stream_ptr) {
  using namespace arma_ne;
  if (S <= 0 || p < 0 || q < 0 || q > 5 || n_obs <= (p > q ? p : q) ||
      p + q + icpt == 0 || (icpt != 0 && icpt != 1))
    return -1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_rows::Tile tl;
  if (!stage_rows::make_tile(S, n_obs, 0, lanes, sms, &tl))
    return -1;
  const RowsArgs args{params, y, nv, nullptr, nullptr, nullptr, sse,
                      S, n_obs, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  switch (q) {
    case 0: return launch_css_rows_p<0>(icpt, p, args, tl, st);
    case 1: return launch_css_rows_p<1>(icpt, p, args, tl, st);
    case 2: return launch_css_rows_p<2>(icpt, p, args, tl, st);
    case 3: return launch_css_rows_p<3>(icpt, p, args, tl, st);
    case 4: return launch_css_rows_p<4>(icpt, p, args, tl, st);
    case 5: return launch_css_rows_p<5>(icpt, p, args, tl, st);
    default: return -1;
  }
}
