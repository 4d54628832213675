// The one-pass Holt-Winters SSE and gradient over the callers' layout
// (hw_sse_rows_kernel): the kernel behind ops/hw_sse.py::value_and_grad
// and its evaluator, one launch a call.  Its design and bound are in the
// source note of csrc/hw_sse.cu; this file is a part of that library.
//
// A block runs blockDim.x consecutive series, one thread a series.  Each
// thread runs hw_step (hw_step.cuh) on its lane, step by step, as the
// time-major hw_sse_kernel does, in the roundings that kernel has at the
// lane's period, so every lane's bits are that kernel's; what differs is
// where the season ring lives and how y arrives.
//
// The ring: slot j of a lane is one float4 (s, ds/dalpha, ds/dbeta,
// ds/dgamma) at ring[j * stride + column].  In shared memory (the rule)
// the column is the thread and the stride the block's lanes, so a warp's
// 32 float4 of one slot are 512 contiguous bytes, read and written
// without bank conflicts: every lane of a block stands at the same step.
// A period whose ring does not fit a block of 32 lanes (m > ~450) keeps
// its ring in a global scratch of the same layout, the column then being
// the thread's index in the grid: the same pass, the same bits.
//
// y: each warp stages windows of kWin steps of its 32 lanes through a
// tile of its own in shared memory (one window), with 4-byte cp.async
// (stage_rows.cuh) from any strided (n_steps, S) view: series-major rows
// (the caller's (S, n) panel from column m on, step stride 1) or a
// time-major copy (lane stride 1).  The tile is [step][lane] at a pitch
// of kPitch = 36 floats: a warp's copies of 4 rows x 8 steps
// (series-major; each row's 8 steps are 32 contiguous bytes) or of one
// step x 32 lanes (time-major; 128 bytes) land in 32 different banks,
// and so do its reads of one step.  A thread reads its window into
// registers, the warp then issues the next window's copies, and the
// steps of the window run while they land.  Rows come in 32-byte pieces
// (each one sector: the windows start where the rows' pieces align),
// which cost the card more than a time-major copy's 128-byte ones
// (PERF.md), but far less than making that copy each call.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hw_step.cuh"
#include "stage_rows.cuh"

namespace {

using hw::hw_step;
using hw::Smoothing;
using hw::step_weight;

// The window and the residency (PERF.md records the values tried on the
// H100: windows of 4 and 16 steps, 5 and 7 blocks, two windows a tile).
constexpr int kMaxLanes = 128;  // threads (lanes) a block
constexpr int kMinBlocks = 6;   // resident blocks an SM: <= 80 registers
constexpr int kWin = 8;         // steps a staged window: 32 bytes of a row
// floats between a tile's steps: a series-major copy puts 32 / kWin rows
// of kWin steps in 32 different banks
constexpr int kPitch = 32 + 32 / kWin;
constexpr int kTileFloats = kWin * kPitch;  // a warp's tile: one window
constexpr int kTileBytesPerLane = kTileFloats * 4 / 32;
static_assert(32 % kWin == 0, "a window's steps must divide a warp");

// The periods whose steps round as the time-major kernel's ring in
// registers (hw_sse.cu's in_registers); any other rounds as its ring in
// memory.  The ring of these always fits a block in shared memory.
inline bool register_period(int m) {
  return m == 4 || m == 7 || m == 12 || m == 24;
}

struct RowsArgs {
  const float* params;   // (3, S) at strides (p_comp, p_lane)
  const float* init;     // (2 + m, S) contiguous
  const float* y;        // (n_steps, S) at strides (y_step, y_lane)
  const float* nv;       // (S,) or null
  float4* ring;          // global ring (m, blocks * lanes), or null
  float* out;            // (4, S) contiguous
  long long p_lane, p_comp, y_lane, y_step;
  int S, n_steps, m;
  int t_first;           // the first window's step, in (-kWin, 0]
};

// How a launch walks the panel; made on the host by make_tile.
struct Tile {
  int lanes;         // lanes (threads) a block
  int ring_in_smem;  // 1: the ring in shared memory; 0: in the scratch
  int smem;          // dynamic shared memory bytes a block
  int blocks;        // blocks of the launch
};

inline long long tile_bytes(int lanes, int m, bool ring_in_smem) {
  return static_cast<long long>(lanes) *
         ((ring_in_smem ? 16LL * m : 0) + kTileBytesPerLane);
}

// The tile of S lanes at period m on a card with `sms` SMs and `optin`
// bytes of shared memory a block: the widest block that still gives every
// SM two blocks (stage_rows::pick_lanes), narrowed to 32 lanes while its
// ring does not fit.  The ring goes to the global scratch only where 32
// lanes' ring does not fit either.
inline void make_tile(long long S, int m, int sms, int optin, Tile* t) {
  int lanes = stage_rows::pick_lanes(S, sms);
  while (lanes > 32 && tile_bytes(lanes, m, true) > optin) lanes /= 2;
  t->lanes = lanes;
  t->ring_in_smem = tile_bytes(lanes, m, true) <= optin ? 1 : 0;
  t->smem = static_cast<int>(tile_bytes(lanes, m, t->ring_in_smem != 0));
  t->blocks = static_cast<int>((S + lanes - 1) / lanes);
}

// The first window's step: windows of series-major rows start where the
// rows' kWin-float pieces are aligned (one 32-byte sector each at kWin =
// 8, not two), when every row shares the first row's alignment; the
// steps before 0 are neither copied nor run.  0 otherwise.
inline int first_window(const float* y, long long y_step, long long y_lane) {
  if (y_step != 1 || y_lane % kWin != 0) return 0;
  const long long off =
      static_cast<long long>(reinterpret_cast<uintptr_t>(y) / 4) % kWin;
  return -static_cast<int>(off);
}

// A thread's share of its warp's window copies.  Element e = 32 j + i of
// the warp's j-th copy: series-major (ROWS), lane e / kWin at step
// e % kWin, so kWin threads read one row's 4 kWin contiguous bytes;
// time-major, lane i at step j.  Copy j of the window at t0 reads
// src + t0 * y_step + j * dj into dst[j * dd]; ok says which copies'
// lanes are below S (bit j, or all of them).
template <bool ROWS>
struct Stager {
  const float* src;
  long long dj;
  float* dst;
  unsigned ok;
  int t;  // ROWS: the step within the window of every copy of the thread

  __device__ __forceinline__ Stager(const RowsArgs& A, long long s_w,
                                    float* tile, int i) {
    const int r = ROWS ? i / kWin : i;
    t = ROWS ? i % kWin : 0;
    src = A.y + (s_w + r) * A.y_lane + t;
    dj = ROWS ? (32 / kWin) * A.y_lane : A.y_step;
    dst = tile + t * kPitch + r;
    ok = 0;
#pragma unroll
    for (int j = 0; j < kWin; ++j)
      ok |= (s_w + r + (ROWS ? j * (32 / kWin) : 0) < A.S ? 1u : 0u) << j;
  }

  // Issues the copies of steps [t0, t0 + kWin) (those in [0, n_steps))
  // into the tile, as one group (empty past the series' end).
  __device__ __forceinline__ void issue(int t0, long long y_step,
                                        int n_steps) const {
    const float* q = src + t0 * y_step;
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const int at = ROWS ? t0 + t : t0 + j;
      const bool in = ((ok >> j) & 1u) && at >= 0 && at < n_steps;
      if (in)
        stage_rows::cp_async4(dst + j * (ROWS ? 32 / kWin : kPitch), q);
      q += dj;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// Waits until the thread's copies of the window in flight have landed,
// then for the warp's.
__device__ __forceinline__ void wait_window() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// REG: the lane's period is a register_period, whose steps round as the
// time-major kernel's ring in registers.
template <bool ADD, bool RAGGED, bool REG, bool SMEM_RING, bool ROWS>
__global__ void __launch_bounds__(kMaxLanes, kMinBlocks)
hw_sse_rows_kernel(const RowsArgs A) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, i = tid & 31, lanes = blockDim.x;
  const long long s = static_cast<long long>(blockIdx.x) * lanes + tid;
  const bool live = s < A.S;
  const int m = A.m, n_steps = A.n_steps;
  const size_t S = static_cast<size_t>(A.S);
  float* const tile = smem + (SMEM_RING ? 4 * m * lanes : 0) +
                      (tid >> 5) * kTileFloats;
  // the lane's ring slot j at ring[j * stride]: shared memory offsets fit
  // 32 bits, a global scratch's need not
  using Off = typename std::conditional<SMEM_RING, unsigned, size_t>::type;
  float4* const ring =
      SMEM_RING ? reinterpret_cast<float4*>(smem) + tid : A.ring + s;
  const Off stride = static_cast<Off>(SMEM_RING ? lanes : gridDim.x) *
                     static_cast<Off>(SMEM_RING ? 1 : lanes);
  const Stager<ROWS> stager(A, s - i, tile, i);
  stager.issue(A.t_first, A.y_step, n_steps);

  // a lane past S runs the pass on zeros and writes nothing: every thread
  // of a warp stages and meets at the warp's barriers
  const Smoothing p(live ? A.params[s * A.p_lane] : 0.0f,
                    live ? A.params[s * A.p_lane + A.p_comp] : 0.0f,
                    live ? A.params[s * A.p_lane + 2 * A.p_comp] : 0.0f);
  const float n_valid = RAGGED && live ? A.nv[s] : 0.0f;
  float level = live ? A.init[s] : 0.0f;
  float trend = live ? A.init[S + s] : 0.0f;
  float dl[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  float sse = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < m; ++j)
    ring[j * stride] =
        make_float4(live ? A.init[(2 + j) * S + s] : 0.0f, 0.0f, 0.0f, 0.0f);
  wait_window();

  // reads the window at t0 into x, then issues the copies of the next
  auto next_window = [&](float (&x)[kWin], const int t0) {
#pragma unroll
    for (int j = 0; j < kWin; ++j) x[j] = tile[j * kPitch + i];
    __syncwarp();  // the whole window is read before the tile refills
    stager.issue(t0 + kWin, A.y_step, n_steps);
  };
  // step t on the lane's ring slot t mod m
  Off slot = 0;
  const Off end = static_cast<Off>(m) * stride;
  auto step = [&](const float x, const int t) {
    const float4 r = ring[slot];
    float sv = r.x, ds[3] = {r.y, r.z, r.w};
    hw_step<ADD, RAGGED, REG>(x, step_weight<RAGGED>(m + t, n_valid), p,
                              level, trend, dl, db, sv, ds, sse, grad);
    ring[slot] = make_float4(sv, ds[0], ds[1], ds[2]);
    slot += stride;
    if (slot == end) slot = 0;
  };
  for (int t0 = A.t_first; t0 < n_steps; t0 += kWin) {
    float x[kWin];
    next_window(x, t0);
    if (t0 >= 0 && t0 + kWin <= n_steps) {
#pragma unroll
      for (int j = 0; j < kWin; ++j) step(x[j], t0 + j);
    } else {
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        if (t0 + j >= 0 && t0 + j < n_steps) step(x[j], t0 + j);
    }
    wait_window();
  }
  if (live) {
    A.out[s] = sse;
#pragma unroll
    for (int j = 0; j < 3; ++j) A.out[(1 + j) * S + s] = grad[j];
  }
}

using RowsKernel = void (*)(const RowsArgs);

template <bool REG, bool SMEM_RING, bool ROWS>
RowsKernel pick_rows_of(bool additive, bool ragged) {
  if (additive)
    return ragged ? &hw_sse_rows_kernel<true, true, REG, SMEM_RING, ROWS>
                  : &hw_sse_rows_kernel<true, false, REG, SMEM_RING, ROWS>;
  return ragged ? &hw_sse_rows_kernel<false, true, REG, SMEM_RING, ROWS>
                : &hw_sse_rows_kernel<false, false, REG, SMEM_RING, ROWS>;
}

// The instantiation: additive or not, ragged or not, the period's
// roundings, the ring in shared memory or not (a register period's
// always is), y series-major (step stride 1) or not.
RowsKernel pick_rows(bool additive, bool ragged, int m, bool smem_ring,
                     bool rows) {
  if (register_period(m))
    return rows ? pick_rows_of<true, true, true>(additive, ragged)
                : pick_rows_of<true, true, false>(additive, ragged);
  if (smem_ring)
    return rows ? pick_rows_of<false, true, true>(additive, ragged)
                : pick_rows_of<false, true, false>(additive, ragged);
  return rows ? pick_rows_of<false, false, true>(additive, ragged)
              : pick_rows_of<false, false, false>(additive, ragged);
}

cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Lets the kernel take the tile's shared memory and asks for the largest
// shared-memory carve-out, since shared memory bounds its resident
// blocks; set on every launch, since the attributes are the device's.
cudaError_t set_smem(RowsKernel kernel, int bytes) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// The tile of S lanes at period m, y series-major (rows 1: step stride 1)
// or not, into out[0..7] = (lanes a block, 1 if the ring is in shared
// memory, dynamic shared bytes a block, blocks, resident blocks per SM,
// SMs, registers a thread, local (spill) bytes a thread).  The caller
// sizes the global ring, where the tile has none in shared memory, to
// (m, blocks * lanes) float4.  Returns 0, a cudaError_t, or -1 for bad
// arguments.
extern "C" int hw_sse_rows_config(int S, int m, int additive, int ragged,
                                  int rows, int* out) {
  if (S <= 0 || m < 1) return -1;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tile tl;
  make_tile(S, m, sms, optin, &tl);
  const RowsKernel kernel = pick_rows(additive != 0, ragged != 0, m,
                                      tl.ring_in_smem != 0, rows != 0);
  err = set_smem(kernel, tl.smem);
  int blocks_per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, reinterpret_cast<const void*>(kernel), tl.lanes,
        tl.smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = tl.lanes;
  out[1] = tl.ring_in_smem;
  out[2] = tl.smem;
  out[3] = tl.blocks;
  out[4] = blocks_per_sm;
  out[5] = sms;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// Launches on `stream` with hw_sse_rows_config's tile for the same S and
// m; does not synchronise, allocates nothing.  params (3, S) and y
// (n_steps, S) at the strides given (in floats; each at least 1 where it
// moves), init (2 + m, S) and out (4, S) contiguous, nv (S,) or null,
// ring (m, blocks * lanes) float4 where the tile keeps no ring in shared
// memory, else null.  Returns 0, a cudaError_t, or -1 for bad arguments.
extern "C" int hw_sse_rows_launch(
    const float* params, long long p_comp, long long p_lane,
    const float* init, const float* y, long long y_step, long long y_lane,
    const float* nv, float* ring, float* out, int S, int n_steps, int m,
    int additive, void* stream_ptr) {
  if (S <= 0 || n_steps < 1 || m < 1 || p_comp < 0 || p_lane < 0 ||
      y_step < 0 || y_lane < 0)
    return -1;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Tile tl;
  make_tile(S, m, sms, optin, &tl);
  if (!tl.ring_in_smem && ring == nullptr) return -1;
  const RowsKernel kernel = pick_rows(additive != 0, nv != nullptr, m,
                                      tl.ring_in_smem != 0, y_step == 1);
  err = set_smem(kernel, tl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  RowsArgs args{params, init, y, nv,
                tl.ring_in_smem ? nullptr : reinterpret_cast<float4*>(ring),
                out, p_lane, p_comp, y_lane, y_step, S, n_steps, m,
                first_window(y, y_step, y_lane)};
  void* kernel_args[] = {&args};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                         dim3(tl.blocks), dim3(tl.lanes), kernel_args,
                         tl.smem, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
