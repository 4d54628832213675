// Fused ARMA normal equations (arma_ne_rows_kernel over the series-major
// panel; arma_ne_kernel, the same pass over the time-major panel, kept as
// its comparison), the whole CSS Levenberg-Marquardt fit of a panel or of
// a candidate grid over one panel in one launch (arma_lm_fit_kernel), and
// the CSS cost alone (arma_css_rows_kernel in arma_ne.sse.cu; its
// time-major comparison arma_css_kernel below).  The device code of the
// passes is in arma_ne.cuh and arma_ne_rows.cuh and their instantiations
// in arma_ne.orders*.cu, and this file holds the C interface that picks
// an instantiation.

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
// The series-major pass (arma_ne_rows_kernel), the one the callers
// launch: params (S, k), y (S, n_obs), nv (S,) or null and an optional
// (S, k) 0/1 mask, as ops/arma_ne.py's callers hold them; outputs JtJ
// (S, k, k) with both triangles, Jtr (S, k) and sse (S,), what
// normal_equations returns, so a call launches this kernel and nothing
// else.  One thread a lane runs ne_pass, the explicit-FMA pass that
// arma_ne_kernel runs, so each output equals that kernel's bit for bit.
// A block of 32-128 consecutive lanes copies their whole rows of y into
// shared memory (stage_rows.cuh: 4-byte cp.async, an odd row pitch, up
// to 72 KB a block) and stages its outputs back through it, so every
// global load and store is coalesced.  The block's lane count comes from
// S (stage_rows::pick_lanes): 128 while every SM still gets two blocks,
// down to 32 for the gathered launches of a few thousand lanes, and
// narrower where a long row needs it to fit whole; rows too long for 32
// lanes (n_obs > 575) are read from global memory by the same pass.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores) at the main path's (2,1,2)+c, S = 131072, n_obs = 127: it must
// read y (66.6 MB) and params (2.6 MB) and write JtJ, Jtr and sse (31
// floats a lane, 16.3 MB), ~26 us; it does 76 flop per lane-step (yhat 8,
// e 1, T 25, sse 2, triu 30, Jtr 10) x 125 steps x 131072 lanes = 1.25
// GFLOP, ~19 us.  So bytes bound it on paper.  On the card (PERF.md §6)
// both passes issue ~45 instructions a lane-step, and what separates
// them is residency: the time-major pass keeps 32 warps an SM in one
// wave, loading as it goes, while a whole-row tile holds 508 B of shared
// memory a lane, at most ~14 warps an SM, and 1024 blocks run in ~2.6
// waves that each copy their rows before they compute; so at full width
// the staged pass takes ~1.5x the time-major one's device time (a ring
// of double-buffered windows, at twice the residency, measured slower
// still: its windows' barriers cost more than the residency gains).  At
// the widths the paths give it (8192 lanes and fewer) either pass takes
// one lane's serial chain, ~12 us, whatever the block's lane count; the
// call, with no transposes or unpack around the kernel, is 2-3x faster
// than before at every width.
//
// The time-major pass (arma_ne_kernel), the comparison: params (k, S),
// y (n_obs, S), out (n_out, S) with n_out = 1 + k(k+1)/2 + k laid out
// [sse, triu(JtJ)..., Jtr...]; one thread a lane reads y_t straight from
// global memory each step (a warp's loads at step t are 32 consecutive
// floats).  Its callers had to transpose y and params and unpack the
// triangle around it.  All float32.
//
// The carry (e ring, T ring, y ring, sse, triu, Jtr, coefficients: about
// 40 floats at (2,1,2) with intercept) stays in registers; every form is
// templated on (P, Q, ICPT, RAGGED) so every inner loop unrolls.  Orders
// p, q <= 5 are instantiated, with and without intercept.

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
// over arma_ne_kernel; the pass fuses each product into its sum
// explicitly (__fmaf_rn; see ne_pass), so that its rounding does not
// depend on the instantiation either.  An optional (k, S) mask of 0/1
// freezes parameter slots, as in the loop: the pass runs at x * mask and
// its JtJ and Jtr are post-scaled.  Outputs x (k, S), fun (the sse),
// converged, n_iter; a lane ran 1 + n_iter passes.
//
// The candidate grid (the Pallas kernel's y_blocks mode, which pairs
// parameter block i with panel block i % y_blocks): S = C * S_y lanes,
// candidate-major, over one (n_obs, S_y) panel; lane i reads y column and
// n_valid entry i % S_y and its own column i of x0, mask and the outputs,
// in the padded layout [c, AR(max_p), MA(max_q)] with a 0/1 mask.  No
// lane padding is needed (the TPU padded each candidate's run to its
// 1024-lane blocks).  A warp holds 32 consecutive series of one
// candidate, so its y loads stay coalesced.  It runs in one of two ways:
//
// - padded: one launch at <max_p, max_q> over all C * S_y lanes; each lane
//   computes every slot, its masked ones multiplied by 0.  At (5,5,1) the
//   state takes 255 registers and a ~220 B spill, 2 blocks of 128 an SM,
//   and a lane-step costs 298 flop whatever the lane's own order (8 at
//   (0,0)+c, 76 at (2,2)+c).
// - per candidate (the auto-fit screen, ops/arma_ne.py's grid_orders):
//   candidate c's S_y lanes, one contiguous block, are one launch of the
//   <p_c, q_c> instantiation (lane0 = c * S_y, theta_slot = icpt + max_p,
//   t0 = max(max_p, max_q)), which reads and writes only the slots it
//   owns; the wrapper leaves x0 * mask in the others.  Each candidate
//   then runs at its own registers, residency and flop a step.  A masked
//   slot of the padded form contributes exact zeros (0 * y terms in the
//   sums, zero rows of JtJ, Cholesky rows that are zero but for their
//   1e-6 diagonal and solve to delta = 0), so on finite lanes the two
//   forms agree bit for bit.
//
// The resident lanes of one launch are a fraction of one candidate's run
// at S_y = 131072, so the y columns a pass re-reads (~17 MB for ~34k
// lanes at n_obs = 128) stay in the 50 MB L2, while each candidate's
// sweep over the 64 MiB panel comes from HBM at worst: C reads of the
// panel a grid, not one.
//
// Its bound is operations: 76 flop x 125 steps per pass at (2,1,2), and a
// lane needs 1 + n_iter passes (a mean of ~13 on the main path's panel,
// at most 51), so at S = 131072 the chunk's ~1.8e6 passes are ~1.7e10
// flop, ~0.25 ms at 67 TFLOP/s; its one read of the inputs is ~0.02 ms.
// chip_smoke.py's grid bound charges each lane its own order's step.
// The design keeps the LM state (x, lam, f, the accepted triu(JtJ) and
// Jtr, the trial) in registers beside the pass's carry (113 registers at
// (2,1,2), 175 at (3,3,1)) and reads y from global memory on every pass:
// time-major, so a warp's loads are coalesced because its threads hold
// consecutive lanes.  From about k = 10 that state, the pass's carry and the trial's
// sums (about 270 live floats at (5,5,1)) exceed the 255 registers a
// thread may hold, and the compiler keeps a few dozen of them in local
// memory (PERF.md); moving the accepted state to shared memory laid out
// [entry][thread] was tried and moved neither registers nor spills, so
// it stays in registers.  A warp waits for its slowest lane (warp
// efficiency 0.28 on the main path's panel); a lane queue that handed
// finished threads further lanes lifted that to 0.44 but scattered each
// warp's loads and measured 1.4-1.7x slower (PERF.md), so each thread
// fits its own lane.

#include "arma_ne_rows.cuh"

namespace arma_ne {
namespace {

// ---------------------------------------------------------------------------
// The CSS cost alone over the time-major panel (arma_css_kernel), the
// comparison of arma_css_rows_kernel (arma_ne.sse.cu, which holds the
// cost's note): per lane, sse = sum_{t >= max(p, q)} e_t^2 with the
// recurrence above and only the e ring carried; ragged lanes weight e by
// (t < nv) before the accumulator and the ring push.  Q (<= 5) is
// static, and so is P for p <= 5 (kCssStaticP); a larger p (P = -1) runs
// the runtime form, whose AR terms read their y lags and coefficients
// where they lie.  params (k, S), y (n_obs, S), output (1, S).

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

// ---------------------------------------------------------------------------
// Dispatch to the per-order instantiations of arma_ne.orders*.cu.

bool order_ok(int p, int q, int icpt) {
  return p >= 0 && q >= 0 && p <= kMaxOrder && q <= kMaxOrder &&
         (icpt == 0 || icpt == 1) && p + q + icpt > 0;
}

cudaError_t launch_ne_order(int p, int q, int icpt, const float* params,
                            const float* y, const float* nv, float* out,
                            int S, int n_obs, cudaStream_t st) {
#define ARMA_NE_CASE(PP, QQ)                                           \
  if (p == PP && q == QQ)                                              \
    return ne_launch_##PP##_##QQ(icpt, params, y, nv, out, S, n_obs, st);
  ARMA_NE_FOR_EACH_ORDER(ARMA_NE_CASE)
#undef ARMA_NE_CASE
  return cudaErrorInvalidValue;
}

cudaError_t launch_ne_rows_order(int p, int q, int icpt, const RowsArgs& A,
                                 const stage_rows::Tile& tl,
                                 cudaStream_t st) {
#define ARMA_NE_ROWS_CASE(PP, QQ) \
  if (p == PP && q == QQ) return ne_rows_launch_##PP##_##QQ(icpt, A, tl, st);
  ARMA_NE_FOR_EACH_ORDER(ARMA_NE_ROWS_CASE)
#undef ARMA_NE_ROWS_CASE
  return cudaErrorInvalidValue;
}

LmKernel pick_lm(int p, int q, int icpt, bool ragged) {
#define ARMA_LM_CASE(PP, QQ) \
  if (p == PP && q == QQ) return lm_pick_##PP##_##QQ(icpt, ragged);
  ARMA_NE_FOR_EACH_ORDER(ARMA_LM_CASE)
#undef ARMA_LM_CASE
  return nullptr;
}

// The launch configuration: the kernel, its grid (a thread for every
// lane), its residency and its registers.
struct LmConfig {
  LmKernel kernel;
  int blocks, blocks_per_sm, sms, registers, local_bytes;
};

bool lm_args_ok(int S, int S_y, int n_obs, int p, int q, int icpt,
                int threads) {
  return S > 0 && S_y > 0 && S % S_y == 0 && order_ok(p, q, icpt) &&
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

}  // namespace
}  // namespace arma_ne

using arma_ne::LmArgs;
using arma_ne::LmConfig;

// The tile a series-major one-pass launch of S lanes takes
// (stage_rows::make_tile) into out[0..4] = (lanes a block, 1 if the rows
// are staged in shared memory, row pitch, shared-memory bytes a block,
// blocks).  cost_only selects the cost kernel's tile (no outputs staged);
// lanes 0 picks it from S and n_obs.  Returns 0, or -1 for arguments no
// tile serves.
extern "C" int arma_rows_tile(int S, int n_obs, int p, int q, int icpt,
                              int cost_only, int lanes, int* out) {
  if (S <= 0 || p < 0 || q < 0 || n_obs <= (p > q ? p : q)) return -1;
  const int k = icpt + p + q;
  const int outs = cost_only ? 0
                             : stage_rows::odd(k * k) + stage_rows::odd(k);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  stage_rows::Tile t;
  if (!stage_rows::make_tile(S, n_obs, outs, lanes, sms, &t)) return -1;
  const int vals[5] = {t.lanes, t.staged, t.pitch, t.smem, t.blocks};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return 0;
}

// The series-major normal-equations pass of S lanes on `stream`: params
// (S, k), y (S, n_obs), nv (S,) or null, mask (S, k) or null; writes jtj
// (S, k, k), jtr (S, k), sse (S,).  lanes 0 picks the tile (see
// arma_rows_tile).  Does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 on success), or -1 for an order outside
// p, q <= 5 / k == 0, a bad shape or a tile no launch serves.
extern "C" int arma_ne_rows_launch(const float* params, const float* y,
                                   const float* nv, const float* mask,
                                   float* jtj, float* jtr, float* sse, int S,
                                   int n_obs, int p, int q, int icpt,
                                   int lanes, void* stream_ptr) {
  if (S <= 0 || n_obs <= (p > q ? p : q) || !arma_ne::order_ok(p, q, icpt))
    return -1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k = icpt + p + q;
  stage_rows::Tile tl;
  if (!stage_rows::make_tile(S, n_obs,
                             stage_rows::odd(k * k) + stage_rows::odd(k),
                             lanes, sms, &tl))
    return -1;
  const arma_ne::RowsArgs args{params, y, nv, mask, jtj, jtr, sse,
                               S, n_obs, p};
  return static_cast<int>(arma_ne::launch_ne_rows_order(
      p, q, icpt, args, tl, static_cast<cudaStream_t>(stream_ptr)));
}

// The time-major cost-only kernel (the comparison of arma_css_rows_launch):
// as arma_ne_launch, for any p >= 0 and q <= 5; `out` is (1, S).
extern "C" int arma_css_launch(const float* params, const float* y,
                               const float* nv, float* out, int S, int n_obs,
                               int p, int q, int icpt, void* stream_ptr) {
  using namespace arma_ne;
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

// The time-major normal-equations pass (the comparison of
// arma_ne_rows_launch): params (k, S), y (n_obs, S), nv (S,) or null, out
// (n_out, S) packed.  Launches on `stream`, does not synchronise,
// allocates nothing.  Returns the cudaError_t of the launch (0 on
// success), or -1 for an order outside p, q <= 5 / k == 0 or a bad shape.
extern "C" int arma_ne_launch(const float* params, const float* y,
                              const float* nv, float* out, int S, int n_obs,
                              int p, int q, int icpt, void* stream_ptr) {
  if (S <= 0 || n_obs <= (p > q ? p : q) || !arma_ne::order_ok(p, q, icpt))
    return -1;
  return static_cast<int>(arma_ne::launch_ne_order(
      p, q, icpt, params, y, nv, out, S, n_obs,
      static_cast<cudaStream_t>(stream_ptr)));
}

// The LM fit's launch configuration for `threads` a block into cfg[0..4]
// = (blocks, resident blocks per SM, SMs, registers a thread, local
// (spill) bytes a thread).  Returns 0, a cudaError_t, or -1 for bad
// arguments or a block that cannot be resident.
extern "C" int arma_lm_fit_config(int S, int n_obs, int p, int q, int icpt,
                                  int ragged, int threads, int* cfg) {
  if (!arma_ne::lm_args_ok(S, S, n_obs, p, q, icpt, threads)) return -1;
  LmConfig c;
  const cudaError_t err =
      arma_ne::lm_config(S, p, q, icpt, ragged != 0, threads, &c);
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

// Launches the whole LM fit of S lanes over an S_y-series panel on
// `stream`; does not synchronise, allocates nothing.  The launch fits
// lanes lane0 .. lane0 + S - 1 of an S_all-lane layout: x0 (k_pad, S_all),
// y (n_obs, S_y), nv (S_y,) or null, mask (k_pad, S_all) or null; outputs
// x (k_pad, S_all), fun, converged, n_iter (S_all,), one thread a lane in
// blocks of `threads`.  Lane i reads series i % S_y.  ARMA(p, q) owns
// slot 0 (with icpt), the AR slots icpt .. icpt + p - 1 and the MA slots
// theta_slot .. theta_slot + q - 1 of x0, mask and x, and writes no
// other; its CSS window starts at t0.  The per-series fit is lane0 = 0,
// S_all = S, theta_slot = icpt + p, t0 = max(p, q).  Returns 0, a
// cudaError_t, or -1 for bad arguments.
extern "C" int arma_lm_fit_launch(
    const float* x0, const float* y, const float* nv, const float* mask,
    float* x, float* fun, unsigned char* converged, int* n_iter, int S,
    int S_y, int n_obs, int p, int q, int icpt, float tol, int max_iter,
    int lane0, int S_all, int theta_slot, int t0, int threads,
    void* stream_ptr) {
  if (!arma_ne::lm_args_ok(S, S_y, n_obs, p, q, icpt, threads) ||
      lane0 < 0 || static_cast<long long>(lane0) + S > S_all ||
      theta_slot < icpt + p || t0 < (p > q ? p : q) || t0 >= n_obs)
    return -1;
  LmConfig c;
  cudaError_t err =
      arma_ne::lm_config(S, p, q, icpt, nv != nullptr, threads, &c);
  if (err == cudaErrorInvalidValue && c.kernel == nullptr) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.blocks_per_sm < 1) return -1;
  LmArgs args{x0, y, nv, mask, x, fun, converged, n_iter, S, S_y, n_obs,
              tol, max_iter, lane0, S_all, theta_slot, t0};
  void* kernel_args[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(c.kernel),
                         dim3(c.blocks), dim3(threads), kernel_args, 0,
                         static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
