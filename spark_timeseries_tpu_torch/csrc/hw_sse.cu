// Fused Holt-Winters SSE value and gradient: the one pass of
// ops/hw_sse.py::value_and_grad (hw_sse_rows_kernel, in
// csrc/hw_sse.rows.cu, a part of this library), the time-major
// hw_sse_kernel it replaced (kept below as its comparison), and the whole
// projected-gradient box fit of a panel in one persistent launch
// (hw_box_fit_kernel, further down).  The last two run hw_step below,
// whose contraction into FMAs is nvcc's; the rows kernel runs the same
// step with nvcc's roundings written out (hw_step.cuh), so all three
// agree bit for bit.
//
// Replaces the Pallas TPU kernel docs/experiments/hw_pallas.py::_hw_kernel
// (itself the drop-in for models/holt_winters.py::_hw_sse_value_and_grad)
// and its panel fit loop docs/experiments/hw_pallas.py::fit_box.  The pass
// computes, per series lane, one sweep over the steps t >= m of the
// R-style components recurrence at (alpha, beta, gamma), carrying the
// level, trend and season ring and their tangents with respect to
// (alpha, beta, gamma), and accumulating
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
// The one pass is bounded on the H100 (3.35 TB/s, 67 TFLOP/s fp32
// outside the tensor cores) at m = 12, n = 120, S = 131072 by bytes: the
// call must read y (108 x S floats, 56.6 MB), init (14 x S, 7.3 MB) and
// params (1.6 MB) and write out (2.1 MB): 67.6 MB, ~20 us.  An additive
// lane-step is 81 flop (base 4, e 2, de 6, lw 1, dlw 3, level 4, dlevel
// 11, trend 5, dtrend 15, sw 1, dsw 3, dseason 12, season 3, sse 2, grad
// 9), 1.15 GFLOP in all, ~17 us.  A thread a lane (the recurrence is
// serial in t) issues ~45 fp32 instructions a step for those flop, so the
// pass comes near its bound only while every scheduler issues on most
// cycles; reading the caller's rows in 32-byte pieces costs it more
// (PERF.md has the measured split).
//
// hw_sse_rows_kernel (csrc/hw_sse.rows.cu): the season ring in shared
// memory, one float4 (s and its three tangents) a slot, laid out
// [slot][lane], so every lane of a block reads and writes one 512-byte
// row of a slot a step without bank conflicts; the carry in registers
// falls to level, trend, their tangents and the accumulators (at most
// 80 registers, for 6 blocks of 128 lanes an SM; 7 blocks at 72
// registers ran slower on the H100, PERF.md).  The same pass runs
// every period, its slot at run time, where the time-major kernel kept
// the ring of any period but 4, 7, 12 and 24 in a (4m, S) global scratch
// (32 bytes of traffic a lane-step).  y comes from the caller's (S, n)
// rows, staged 8 steps a window through a tile a warp with 4-byte
// cp.async (each window one 32-byte sector of a row where the rows
// align), the next window in flight while a window's steps run: the
// call copies no panel time-major.  A period whose ring does not fit a
// block of 32 lanes (m > ~450) keeps it in a global scratch, in the same
// pass.
//
// hw_sse_kernel (the comparison): time-major operands (params (3, S),
// init (2 + m, S), y (n_steps, S) = series[m:] copied, nv (S,) or null,
// out (4, S)), one thread a lane; for m = 4, 7, 12, 24 the ring and its
// tangents (4m floats; 60 floats of carry in all at m = 12) live in
// registers, the pass templated on M and its time loop unrolled by M, so
// step j of each group of M reads and rewrites slot j.  Any other m
// (M = 0 below) runs the generic form, whose ring lives in a scratch
// buffer (4m, T) slot-major, so its accesses stay coalesced: T = S and the
// column is the lane in hw_sse_kernel; in hw_box_fit_kernel T is the
// number of threads in the grid and the column is the thread, because a
// thread there works through many lanes.
//
// hw_box_fit_kernel: per lane, the state machine of the projected-gradient
// fit ops/optimize.py::minimize_box (the JAX _minimize_box_one): project
// x0 into [lower, upper]; evaluate (f, g); each iteration restarts at
// t = 1; a trial x_new = clamp(x - t g) is accepted when
// f_new <= f - 1e-4 g.(x - x_new) and f_new is finite, else t halves, up
// to max_backtracks trials; a lane is done on a step <= tol, on
// |f_new - f| <= tol (|f| + tol), or when no trial is accepted, and
// stops at max_iter iterations.  The solver's arithmetic is written in the
// torch solver's order with __fmul_rn / __fadd_rn / __fsub_rn, so no FMA
// contraction moves an accept or stop decision away from minimize_box over
// the one-pass kernel.  Outputs x (3, S), fun, converged, n_iter and the
// evaluations per lane (value-and-grad passes: 1 + its trials).
//
// Its bound is operations: 81 flop x n_steps per evaluation, and a lane
// needs hundreds of evaluations (a mean of ~350 at m = 12, n = 120), so
// at S = 131072 the chunk's ~4.6e7 passes are ~4e11 flop, ~6 ms at
// 67 TFLOP/s; its one read of the inputs is ~0.02 ms.  Lanes differ
// fiftyfold in their evaluations, so the design keeps threads busy on
// useful passes:
//  - a lane queue: each round of the main loop is ONE pass for every
//    thread; then each thread advances its own lane's state machine, and a
//    thread whose lane is done writes the lane's results and takes the next
//    lane from a global atomicAdd counter.  A warp then runs its 32 threads
//    on 32 lanes' passes until the queue is empty, instead of waiting for
//    its slowest lane (on the monthly panel, warp efficiency 0.36 against
//    0.21 with a lane fixed to each thread: with a few lanes a thread the
//    heaviest lanes still dominate the end).  The grid is the resident
//    blocks (persistent).
//  - the lane's series in shared memory: a thread that takes a lane copies
//    its init (2 + m floats) and y (n_steps floats) into its own column of
//    a dynamic shared tile laid out [row][threadIdx], so every step's read
//    is bank-conflict free and HBM sees y once per fit instead of once per
//    pass (~20 GB a chunk otherwise).  At n = 120, m = 12 the tile is 488
//    bytes a thread, so shared memory, not registers, bounds the resident
//    threads.  A series whose tile does not fit in a block's shared
//    memory reads its column from global memory instead.
//  - the critical path is one lane's serial chain: a lane of 10^4
//    evaluations is 10^6 dependent steps, so the slowest lane sets the
//    kernel's time (PERF.md).  Fewer warps beside it run that chain
//    faster, which is why the wrapper prefers 256-thread blocks (one tile
//    an SM at n = 120) over smaller ones.

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

// A column of a row-major table: row r at p[r * stride].  The lane's
// column of a time-major panel (stride S), or a thread's column of the
// shared tile (stride blockDim.x).
struct Column {
  const float* p;
  size_t stride;
  __device__ __forceinline__ float operator[](int r) const {
    return p[static_cast<size_t>(r) * stride];
  }
};

// The step weight of a ragged lane: 1 while m + t < nv, then 0.
template <bool RAGGED>
__device__ __forceinline__ float step_weight(int m_plus_t, float n_valid) {
  return RAGGED && !(static_cast<float>(m_plus_t) < n_valid) ? 0.0f : 1.0f;
}

// One value-and-grad pass of a lane at (a, b, g).  M > 0: the ring in
// registers (m == M); M == 0: the ring in `ring` (4m rows of stride
// ring_stride, row 4 * slot + c).
template <int M, bool ADD, bool RAGGED>
__device__ __forceinline__ void hw_pass(
    const float a, const float b, const float g, const Column init,
    const Column y, const float n_valid, const int n_steps, const int m,
    float* ring, const size_t ring_stride, float& sse, float (&grad)[3]) {
  float level = init[0], trend = init[1];
  float dl[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  sse = 0.0f;
  grad[0] = grad[1] = grad[2] = 0.0f;
  if constexpr (M > 0) {
    float sea[M], dsea[M][3];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      sea[j] = init[2 + j];
      dsea[j][0] = dsea[j][1] = dsea[j][2] = 0.0f;
    }
    int t = 0;
    for (; t + M <= n_steps; t += M) {
#pragma unroll
      for (int j = 0; j < M; ++j)
        hw_step<ADD, RAGGED>(y[t + j], step_weight<RAGGED>(M + t + j, n_valid),
                             a, b, g, level, trend, dl, db, sea[j], dsea[j],
                             sse, grad);
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (t + j < n_steps)
        hw_step<ADD, RAGGED>(y[t + j], step_weight<RAGGED>(M + t + j, n_valid),
                             a, b, g, level, trend, dl, db, sea[j], dsea[j],
                             sse, grad);
    }
  } else {
    for (int j = 0; j < m; ++j) {
      float* r = ring + static_cast<size_t>(4 * j) * ring_stride;
      r[0] = init[2 + j];
      r[ring_stride] = r[2 * ring_stride] = r[3 * ring_stride] = 0.0f;
    }
    int slot = 0;
    for (int t = 0; t < n_steps; ++t) {
      float* r = ring + static_cast<size_t>(4 * slot) * ring_stride;
      float s = r[0];
      float ds[3] = {r[ring_stride], r[2 * ring_stride], r[3 * ring_stride]};
      hw_step<ADD, RAGGED>(y[t], step_weight<RAGGED>(m + t, n_valid), a, b, g,
                           level, trend, dl, db, s, ds, sse, grad);
      r[0] = s;
      r[ring_stride] = ds[0];
      r[2 * ring_stride] = ds[1];
      r[3 * ring_stride] = ds[2];
      if (++slot == m) slot = 0;
    }
  }
}

constexpr int kThreads = 128;

template <int M, bool ADD, bool RAGGED>
__global__ void __launch_bounds__(kThreads)
hw_sse_kernel(const float* __restrict__ params,
              const float* __restrict__ init, const float* __restrict__ y,
              const float* __restrict__ nv, float* __restrict__ ring,
              float* __restrict__ out, int S, int n_steps, int m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= S) return;
  const size_t stride = static_cast<size_t>(S);
  float sse, grad[3];
  hw_pass<M, ADD, RAGGED>(params[lane], params[stride + lane],
                          params[2 * stride + lane], Column{init + lane, stride},
                          Column{y + lane, stride}, RAGGED ? nv[lane] : 0.0f,
                          n_steps, m, ring == nullptr ? nullptr : ring + lane,
                          stride, sse, grad);
  out[lane] = sse;
#pragma unroll
  for (int j = 0; j < 3; ++j) out[(1 + j) * stride + lane] = grad[j];
}

template <int M, bool ADD>
cudaError_t launch(const float* params, const float* init, const float* y,
                   const float* nv, float* ring, float* out, int S,
                   int n_steps, int m, cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads);
  if (nv != nullptr)
    hw_sse_kernel<M, ADD, true><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, ring, out, S, n_steps, m);
  else
    hw_sse_kernel<M, ADD, false><<<grid, kThreads, 0, stream>>>(
        params, init, y, nv, ring, out, S, n_steps, m);
  return cudaGetLastError();
}

template <bool ADD>
cudaError_t dispatch(const float* params, const float* init, const float* y,
                     const float* nv, float* ring, float* out, int S,
                     int n_steps, int m, cudaStream_t st) {
  switch (m) {
    case 4: return launch<4, ADD>(params, init, y, nv, ring, out, S, n_steps, m, st);
    case 7: return launch<7, ADD>(params, init, y, nv, ring, out, S, n_steps, m, st);
    case 12: return launch<12, ADD>(params, init, y, nv, ring, out, S, n_steps, m, st);
    case 24: return launch<24, ADD>(params, init, y, nv, ring, out, S, n_steps, m, st);
    default: return launch<0, ADD>(params, init, y, nv, ring, out, S, n_steps, m, st);
  }
}

bool in_registers(int m) { return m == 4 || m == 7 || m == 12 || m == 24; }

using SseKernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, int, int, int);

template <int M, bool ADD>
SseKernel pick_sse_variant(bool ragged) {
  return ragged ? &hw_sse_kernel<M, ADD, true> : &hw_sse_kernel<M, ADD, false>;
}

template <bool ADD>
SseKernel pick_sse(int m, bool ragged) {
  switch (m) {
    case 4: return pick_sse_variant<4, ADD>(ragged);
    case 7: return pick_sse_variant<7, ADD>(ragged);
    case 12: return pick_sse_variant<12, ADD>(ragged);
    case 24: return pick_sse_variant<24, ADD>(ragged);
    default: return pick_sse_variant<0, ADD>(ragged);
  }
}

// ---------------------------------------------------------------------------
// The persistent box fit.

constexpr int kMaxBoxThreads = 256;

struct BoxArgs {
  const float* x0;           // (3, S) starting points
  const float* init;         // (2 + m, S)
  const float* y;            // (n_steps, S)
  const float* nv;           // (S,) or null
  float* ring;               // (4m, threads in the grid): generic form only
  float* x;                  // out (3, S)
  float* fun;                // out (S,)
  unsigned char* converged;  // out (S,) bool
  int* n_iter;               // out (S,)
  int* evaluations;          // out (S,)
  int* thread_evals;         // out (threads in the grid,) or null
  int* next_lane;            // the lane queue's head, 0 at launch
  int S, n_steps, m;
  float lower, upper, tol;
  int max_iter, max_backtracks;
};

// torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float project(float v, float lo, float hi) {
  const float r = v < lo ? lo : v;
  return r > hi ? hi : r;
}

template <int M, bool ADD, bool RAGGED, bool SMEM>
__global__ void __launch_bounds__(kMaxBoxThreads)
hw_box_fit_kernel(const BoxArgs A) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t stride = static_cast<size_t>(A.S);
  const size_t gtid = static_cast<size_t>(blockIdx.x) * nthr + tid;
  const size_t n_threads = static_cast<size_t>(gridDim.x) * nthr;
  const int init_rows = 2 + A.m;
  float* ring = A.ring == nullptr ? nullptr : A.ring + gtid;

  // the lane's state: the current point (x, f, g), the pending trial xt
  // and its step t = 2^-k, iterations, evaluations
  float x[3], f = 0.0f, g[3] = {0.0f, 0.0f, 0.0f}, xt[3], t = 1.0f;
  float n_valid = 0.0f;
  int k = 0, it = 0, evals = 0, thread_evals = 0;
  bool first = true;  // the pending pass is the lane's initial evaluation
  // a thread's shared column is the same for every lane it takes
  Column init_c{SMEM ? tile + tid : A.init,
                SMEM ? static_cast<size_t>(nthr) : stride};
  Column y_c{SMEM ? tile + init_rows * nthr + tid : A.y,
             SMEM ? static_cast<size_t>(nthr) : stride};

  int lane = atomicAdd(A.next_lane, 1);
  auto take = [&](int l) {
    if constexpr (SMEM) {
      for (int r = 0; r < init_rows; ++r)
        tile[r * nthr + tid] = A.init[r * stride + l];
      float* yt = tile + init_rows * nthr + tid;
      const float* yg = A.y + l;
#pragma unroll 4
      for (int r = 0; r < A.n_steps; ++r) yt[r * nthr] = yg[r * stride];
    } else {
      init_c = Column{A.init + l, stride};
      y_c = Column{A.y + l, stride};
    }
    if (RAGGED) n_valid = A.nv[l];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = project(A.x0[c * stride + l], A.lower, A.upper);
      xt[c] = x[c];
    }
    first = true;
    k = it = evals = 0;
  };
  if (lane < A.S) take(lane);

  while (lane < A.S) {
    float ft, gt[3];
    hw_pass<M, ADD, RAGGED>(xt[0], xt[1], xt[2], init_c, y_c, n_valid,
                            A.n_steps, A.m, ring, n_threads, ft, gt);
    ++evals;
    bool finished = false, conv = false;
    bool restart = false;  // start the next iteration at t = 1
    if (first) {
      first = false;
      f = ft;
#pragma unroll
      for (int c = 0; c < 3; ++c) g[c] = gt[c];
      if (A.max_iter <= 0) {
        finished = true;
      } else if (A.max_backtracks <= 0) {
        // an iteration with no trial accepts nothing: done
        it = 1;
        finished = conv = true;
      } else {
        restart = true;
      }
    } else {
      // (g * (x - xt)).sum(-1), then f - 1e-4 * decrease
      float dec = __fmul_rn(g[0], __fsub_rn(x[0], xt[0]));
      dec = __fadd_rn(dec, __fmul_rn(g[1], __fsub_rn(x[1], xt[1])));
      dec = __fadd_rn(dec, __fmul_rn(g[2], __fsub_rn(x[2], xt[2])));
      const bool ok = ft <= __fsub_rn(f, __fmul_rn(1e-4f, dec)) && isfinite(ft);
      if (ok) {
        bool small = true;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          small = small && fabsf(__fsub_rn(xt[c], x[c])) <= A.tol;
        const bool stall = fabsf(__fsub_rn(ft, f)) <=
                           __fmul_rn(A.tol, __fadd_rn(fabsf(f), A.tol));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          x[c] = xt[c];
          g[c] = gt[c];
        }
        f = ft;
        ++it;
        if (small || stall) {
          finished = conv = true;
        } else if (it >= A.max_iter) {
          finished = true;
        } else {
          restart = true;
        }
      } else if (++k >= A.max_backtracks) {
        // no trial accepted: a local minimum to tolerance
        ++it;
        finished = conv = true;
      } else {
        t = __fmul_rn(t, 0.5f);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          xt[c] = project(__fsub_rn(x[c], __fmul_rn(t, g[c])), A.lower,
                          A.upper);
      }
    }
    if (restart) {
      k = 0;
      t = 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xt[c] = project(__fsub_rn(x[c], g[c]), A.lower, A.upper);
    }
    if (finished) {
#pragma unroll
      for (int c = 0; c < 3; ++c) A.x[c * stride + lane] = x[c];
      A.fun[lane] = f;
      A.converged[lane] = conv ? 1 : 0;
      A.n_iter[lane] = it;
      A.evaluations[lane] = evals;
      thread_evals += evals;
      lane = atomicAdd(A.next_lane, 1);
      if (lane < A.S) take(lane);
    }
  }
  if (A.thread_evals != nullptr) A.thread_evals[gtid] = thread_evals;
}

using BoxKernel = void (*)(const BoxArgs);

template <int M, bool ADD>
BoxKernel pick_box_variant(bool ragged, bool smem) {
  if (ragged)
    return smem ? &hw_box_fit_kernel<M, ADD, true, true>
                : &hw_box_fit_kernel<M, ADD, true, false>;
  return smem ? &hw_box_fit_kernel<M, ADD, false, true>
              : &hw_box_fit_kernel<M, ADD, false, false>;
}

template <bool ADD>
BoxKernel pick_box(int m, bool ragged, bool smem) {
  switch (m) {
    case 4: return pick_box_variant<4, ADD>(ragged, smem);
    case 7: return pick_box_variant<7, ADD>(ragged, smem);
    case 12: return pick_box_variant<12, ADD>(ragged, smem);
    case 24: return pick_box_variant<24, ADD>(ragged, smem);
    default: return pick_box_variant<0, ADD>(ragged, smem);
  }
}

// The launch configuration: the kernel, its dynamic shared memory (0 when
// the tile does not fit and the lanes read global memory) and the
// persistent grid (every block resident, no more blocks than lanes need).
struct BoxConfig {
  BoxKernel kernel;
  int blocks, smem_bytes, blocks_per_sm, sms, registers, local_bytes;
};

cudaError_t box_config(int S, int n_steps, int m, bool additive, bool ragged,
                       int threads, int max_blocks, BoxConfig* cfg) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t tile = static_cast<size_t>(n_steps + 2 + m) * threads *
                      sizeof(float);
  const bool smem = tile <= static_cast<size_t>(optin);
  cfg->smem_bytes = smem ? static_cast<int>(tile) : 0;
  cfg->kernel = additive ? pick_box<true>(m, ragged, smem)
                         : pick_box<false>(m, ragged, smem);
  const void* fn = reinterpret_cast<const void*>(cfg->kernel);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cfg->smem_bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &cfg->blocks_per_sm, fn, threads, cfg->smem_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  cfg->sms = sms;
  cfg->registers = attr.numRegs;
  cfg->local_bytes = static_cast<int>(attr.localSizeBytes);
  const int wanted = (S + threads - 1) / threads;
  const int resident = cfg->blocks_per_sm * sms;
  cfg->blocks = wanted < resident ? wanted : resident;
  if (max_blocks > 0 && cfg->blocks > max_blocks) cfg->blocks = max_blocks;
  return cudaSuccess;
}

bool box_args_ok(int S, int n_steps, int m, int threads) {
  return S > 0 && n_steps >= 1 && m >= 1 && threads >= 32 &&
         threads <= kMaxBoxThreads && threads % 32 == 0;
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
  if (!in_registers(m) && ring == nullptr) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(
      additive ? dispatch<true>(params, init, y, nv, ring, out, S, n_steps,
                                m, st)
               : dispatch<false>(params, init, y, nv, ring, out, S, n_steps,
                                 m, st));
}

// The time-major kernel's instantiation for (m, additive, ragged):
// cfg[0..3] = (threads a block, resident blocks per SM, registers a
// thread, local (spill) bytes a thread).  Returns 0, a cudaError_t, or -1
// for bad arguments.
extern "C" int hw_sse_config(int m, int additive, int ragged, int* cfg) {
  if (m < 1) return -1;
  const void* fn = reinterpret_cast<const void*>(
      additive ? pick_sse<true>(m, ragged != 0)
               : pick_sse<false>(m, ragged != 0));
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg[0] = kThreads;
  cfg[1] = blocks;
  cfg[2] = attr.numRegs;
  cfg[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// The box fit's launch configuration for `threads` a block and at most
// `max_blocks` blocks (0: the resident blocks), into cfg[0..5] = (blocks,
// dynamic shared bytes, resident blocks per SM, SMs, registers a thread,
// local (spill) bytes a thread).  The caller sizes the generic form's ring
// to blocks * threads columns.  Returns 0, a cudaError_t, or -1 for bad
// arguments or a block that cannot be resident.
extern "C" int hw_box_fit_config(int S, int n_steps, int m, int additive,
                                 int ragged, int threads, int max_blocks,
                                 int* cfg) {
  if (!box_args_ok(S, n_steps, m, threads)) return -1;
  BoxConfig c;
  const cudaError_t err = box_config(S, n_steps, m, additive != 0,
                                     ragged != 0, threads, max_blocks, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.blocks_per_sm < 1) return -1;
  cfg[0] = c.blocks;
  cfg[1] = c.smem_bytes;
  cfg[2] = c.blocks_per_sm;
  cfg[3] = c.sms;
  cfg[4] = c.registers;
  cfg[5] = c.local_bytes;
  return 0;
}

// Launches the whole box fit of S lanes on `stream` with the configuration
// hw_box_fit_config gives for the same arguments (max_blocks included); does not synchronise,
// allocates nothing.  next_lane must hold 0; ring is (4m, blocks *
// threads) for a period outside {4, 7, 12, 24}, else null; thread_evals
// (blocks * threads,) or null.  Returns 0, a cudaError_t, or -1 for bad
// arguments.
extern "C" int hw_box_fit_launch(
    const float* x0, const float* init, const float* y, const float* nv,
    float* ring, float* x, float* fun, unsigned char* converged, int* n_iter,
    int* evaluations, int* thread_evals, int* next_lane, int S, int n_steps,
    int m, int additive, float lower, float upper, float tol, int max_iter,
    int max_backtracks, int threads, int max_blocks, void* stream_ptr) {
  if (!box_args_ok(S, n_steps, m, threads)) return -1;
  if (!in_registers(m) && ring == nullptr) return -1;
  BoxConfig c;
  cudaError_t err = box_config(S, n_steps, m, additive != 0, nv != nullptr,
                               threads, max_blocks, &c);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.blocks_per_sm < 1) return -1;
  BoxArgs args{x0, init, y, nv, ring, x, fun, converged, n_iter,
               evaluations, thread_evals, next_lane, S, n_steps, m,
               lower, upper, tol, max_iter, max_backtracks};
  void* kernel_args[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(c.kernel),
                         dim3(c.blocks), dim3(threads), kernel_args,
                         c.smem_bytes, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
