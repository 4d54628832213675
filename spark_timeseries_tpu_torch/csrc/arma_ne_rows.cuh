// The series-major normal-equations pass (arma_ne_rows_kernel) over the
// shared memory staging of stage_rows.cuh, and the per-order
// instantiations: csrc/arma_ne.cu (the C interface), csrc/arma_ne.sse.cu
// (the cost alone) and the csrc/arma_ne.orders*.cu files include it.
// Each (P, Q) is instantiated in exactly one orders file, through
// ARMA_NE_ORDER(P, Q) at the end of this header, which defines the
// functions arma_ne.cu dispatches to: arma_ne::ne_launch_P_Q,
// arma_ne::ne_rows_launch_P_Q and arma_ne::lm_pick_P_Q.

#pragma once

#include "arma_ne.cuh"
#include "stage_rows.cuh"

namespace arma_ne {

// The series-major one-pass kernels' arguments (arma_ne_rows_kernel,
// arma_css_rows_kernel): lane s reads row s of params (S, k), y
// (S, n_obs) and mask (S, k), and nv[s]; it writes row s of the outputs.
struct RowsArgs {
  const float* params;  // (S, k)
  const float* y;       // (S, n_obs)
  const float* nv;      // (S,) or null
  const float* mask;    // (S, k) of 0/1, or null (normal equations only)
  float* jtj;           // out (S, k, k), both triangles (normal equations)
  float* jtr;           // out (S, k) (normal equations)
  float* sse;           // out (S,)
  int S, n_obs;
  int p;                // the AR order (read by the runtime-p cost form)
};

namespace {

// ---------------------------------------------------------------------------
// One normal-equations pass over the series-major panel (the callers'
// layout): a block of tl.lanes consecutive lanes, one thread a lane, reads
// its rows of y through shared memory (stage_rows.cuh) and runs ne_pass on
// them, so each lane's arithmetic is arma_ne_kernel's.  A row too long to
// stage whole is read from global memory by the same pass.  The mask is
// fused: the pass runs at params * mask and JtJ, Jtr are post-scaled as
// ops/arma_ne.py::_masked_ne scales them (entry [i][j] by mask[i] then
// mask[j]; multiplying by 0 or 1 is exact).  The outputs go through
// shared memory too (the staged rows', free after the pass), so the
// stores of the block's (lanes, k, k) and (lanes, k) ranges are coalesced.

// floats a lane stages its outputs through: JtJ and Jtr at odd pitches
template <int K>
constexpr int ne_rows_out_floats() {
  return stage_rows::odd(K * K) + stage_rows::odd(K);
}

template <int P, int Q, int ICPT, bool RAGGED>
__global__ void __launch_bounds__(stage_rows::kMaxLanes)
arma_ne_rows_kernel(const RowsArgs A, const stage_rows::Tile tl) {
  using O = Order<P, Q, ICPT>;
  constexpr int K = O::K, KK = K * K;
  constexpr int KKP = stage_rows::odd(KK), KP = stage_rows::odd(K);
  extern __shared__ float smem[];
  const int r = threadIdx.x;
  const size_t s0 = static_cast<size_t>(blockIdx.x) * tl.lanes;
  const int left = A.S - static_cast<int>(s0);
  const int rows = left < tl.lanes ? left : tl.lanes;
  const bool live = r < rows;
  const size_t s = s0 + r;
  const bool masked = A.mask != nullptr;
  float prm[O::KA];
#pragma unroll
  for (int x = 0; x < K; ++x) {
    prm[x] = live ? A.params[s * K + x] : 0.0f;
    if (masked && live) prm[x] = __fmul_rn(prm[x], A.mask[s * K + x]);
  }
  const float n_valid = RAGGED && live ? A.nv[s] : 0.0f;
  float sse, jtj[O::NTA], jtr[O::KA];
  if (tl.staged) {
    stage_rows::stage(A.y + s0 * A.n_obs, rows, A.n_obs, tl, smem);
    if (live)
      ne_pass<P, Q, ICPT, RAGGED>(prm, smem + r * tl.pitch, 1, n_valid,
                                  O::ML, A.n_obs, sse, jtj, jtr);
    __syncthreads();  // the outputs below reuse the rows
  } else if (live) {
    ne_pass<P, Q, ICPT, RAGGED>(prm, A.y + s * A.n_obs, 1, n_valid, O::ML,
                                A.n_obs, sse, jtj, jtr);
  }
  float* o_jtj = smem;
  float* o_jtr = smem + tl.lanes * KKP;
  if (live) {
    float* oj = o_jtj + r * KKP;
    float msk[O::KA];
#pragma unroll
    for (int x = 0; x < K; ++x) msk[x] = masked ? A.mask[s * K + x] : 1.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = a; b < K; ++b) {
        const float v = jtj[tri(a, b, K)];
        oj[a * K + b] = masked ? __fmul_rn(__fmul_rn(v, msk[a]), msk[b]) : v;
        oj[b * K + a] = masked ? __fmul_rn(__fmul_rn(v, msk[b]), msk[a]) : v;
      }
      o_jtr[r * KP + a] = masked ? __fmul_rn(jtr[a], msk[a]) : jtr[a];
    }
    A.sse[s] = sse;
  }
  __syncthreads();
  float* gj = A.jtj + s0 * KK;
  for (int f = r; f < rows * KK; f += tl.lanes)
    gj[f] = o_jtj[(f / KK) * KKP + f % KK];
  float* gr = A.jtr + s0 * K;
  for (int f = r; f < rows * K; f += tl.lanes)
    gr[f] = o_jtr[(f / K) * KP + f % K];
}

template <int P, int Q, int ICPT, bool RAGGED>
cudaError_t launch_ne_rows_as(const RowsArgs& A, const stage_rows::Tile& tl,
                              cudaStream_t stream) {
  const cudaError_t err = stage_rows::allow_smem<
      &arma_ne_rows_kernel<P, Q, ICPT, RAGGED>>(tl.smem);
  if (err != cudaSuccess) return err;
  arma_ne_rows_kernel<P, Q, ICPT, RAGGED>
      <<<tl.blocks, tl.lanes, tl.smem, stream>>>(A, tl);
  return cudaGetLastError();
}

template <int P, int Q, int ICPT>
cudaError_t launch_ne_rows(const RowsArgs& A, const stage_rows::Tile& tl,
                           cudaStream_t stream) {
  if constexpr (P + Q + ICPT == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (A.nv != nullptr)
      return launch_ne_rows_as<P, Q, ICPT, true>(A, tl, stream);
    return launch_ne_rows_as<P, Q, ICPT, false>(A, tl, stream);
  }
}

}  // namespace

// Defined by ARMA_NE_ORDER in the orders files, one set per (P, Q).
#define ARMA_NE_DECLARE(P, Q)                                              \
  cudaError_t ne_launch_##P##_##Q(int icpt, const float* params,           \
                                  const float* y, const float* nv,         \
                                  float* out, int S, int n_obs,            \
                                  cudaStream_t stream);                    \
  cudaError_t ne_rows_launch_##P##_##Q(int icpt, const RowsArgs& A,        \
                                       const stage_rows::Tile& tl,         \
                                       cudaStream_t stream);               \
  LmKernel lm_pick_##P##_##Q(int icpt, bool ragged);

#define ARMA_NE_ORDER(P, Q)                                                \
  cudaError_t ne_launch_##P##_##Q(int icpt, const float* params,           \
                                  const float* y, const float* nv,         \
                                  float* out, int S, int n_obs,            \
                                  cudaStream_t stream) {                   \
    return icpt ? launch_ne<P, Q, 1>(params, y, nv, out, S, n_obs, stream) \
                : launch_ne<P, Q, 0>(params, y, nv, out, S, n_obs, stream);\
  }                                                                        \
  cudaError_t ne_rows_launch_##P##_##Q(int icpt, const RowsArgs& A,        \
                                       const stage_rows::Tile& tl,         \
                                       cudaStream_t stream) {              \
    return icpt ? launch_ne_rows<P, Q, 1>(A, tl, stream)                   \
                : launch_ne_rows<P, Q, 0>(A, tl, stream);                  \
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
