// Staging of a block's series-major rows through shared memory, for the
// one-pass ARMA kernels that read the panel as the callers hold it
// (arma_ne_rows_kernel in arma_ne_rows.cuh, arma_css_rows_kernel in
// arma_ne.sse.cu).  A block runs `lanes` consecutive series, one thread a
// series; their rows of y (S, n_obs) are one contiguous range of device
// memory, which the block copies into shared memory before its threads
// run the recurrence on it.  (hw_sse.rows.cu takes pick_lanes and
// cp_async4 for its own windows of rows.)
//
// Copies: 4-byte cp.async (cp.async.ca), one warp a row, its threads on
// consecutive steps, so each warp instruction reads 128 contiguous bytes.
// Not TMA: a 2-D tensor map needs a row stride that is a multiple of 16
// bytes, and the callers' differenced series are n_obs = 127 steps long
// (rows 508 B apart); and not 16-byte cp.async, whose shared-memory
// destination must be 16-byte aligned, which forces a row pitch that is a
// multiple of 4 floats and so bank conflicts in the reads below.
//
// Layout: the block's rows at a pitch of n_obs rounded up to an odd
// number of floats.  Thread i reads row i at one step t, so the 32
// threads of a warp read addresses i * pitch + t, which fall in 32
// different banks because the pitch is odd.
//
// A tile stages the whole rows while they fit in kWholeRowBytes (128
// lanes up to n_obs = 143; 32 lanes up to 575), narrowing its block to
// keep them whole.  Longer rows, which no path of the port gives these
// kernels, are read by each thread straight from its row in global memory
// (the same pass, so the same bits).  A ring of double-buffered time
// windows was measured on the H100 and was slower than the whole row at
// every width tried (PERF.md §6), so no tile takes one.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace stage_rows {

constexpr int kMaxLanes = 128;              // threads (lanes) a block
constexpr int kWholeRowBytes = 72 * 1024;   // 3 blocks an SM at 128 lanes
constexpr int kMaxSmemBytes = 100 * 1024;   // dynamic shared memory a block

// How a launch walks the panel; made on the host by make_tile.
struct Tile {
  int lanes;   // lanes (threads) a block
  int staged;  // 1: the rows in shared memory; 0: read from global memory
  int pitch;   // floats a staged row
  int smem;    // dynamic shared memory bytes a block
  int blocks;  // blocks of the launch
};

__host__ __device__ constexpr int odd(int n) { return n | 1; }

inline bool fits_whole(int lanes, int n_obs) {
  return static_cast<long long>(lanes) * odd(n_obs) * 4 <= kWholeRowBytes;
}

// Lanes a block from the panel's width: the largest of 128, 64 and 32
// that still gives every SM two blocks.  A gathered launch of a few
// thousand lanes then spreads over all SMs instead of filling a few with
// 128-lane blocks, and its time is one lane's serial pass; a full chunk
// gets 128-lane blocks, whose whole-row tiles keep 3 x 64 KB of copies in
// flight an SM.
inline int pick_lanes(long long S, int sms) {
  for (int lanes = kMaxLanes; lanes > 32; lanes /= 2)
    if ((S + lanes - 1) / lanes >= 2LL * sms) return lanes;
  return 32;
}

// The tile of S series of n_obs steps, the kernel staging `out_floats`
// floats a lane of outputs through shared memory.  lanes 0 picks the
// block (above, narrowed while the whole rows do not fit); any other
// value is taken as given.  Returns false for arguments no tile serves
// (lanes not a multiple of 32 in [32, kMaxLanes], or more shared memory
// than kMaxSmemBytes).
inline bool make_tile(long long S, int n_obs, int out_floats, int lanes,
                      int sms, Tile* t) {
  if (lanes <= 0) {
    lanes = pick_lanes(S, sms);
    while (lanes > 32 && !fits_whole(lanes, n_obs)) lanes /= 2;
  }
  if (lanes < 32 || lanes > kMaxLanes || lanes % 32 != 0) return false;
  t->lanes = lanes;
  t->staged = fits_whole(lanes, n_obs) ? 1 : 0;
  t->pitch = t->staged ? odd(n_obs) : 0;
  const long long rows = static_cast<long long>(lanes) * t->pitch;
  const long long outs = static_cast<long long>(lanes) * out_floats;
  const long long bytes = 4 * (rows > outs ? rows : outs);
  if (bytes > kMaxSmemBytes) return false;
  t->smem = static_cast<int>(bytes);
  t->blocks = static_cast<int>((S + lanes - 1) / lanes);
  return true;
}

// Lets KERNEL take more than 48 KB of dynamic shared memory on the
// current device; set on every launch that needs it, since the attribute
// is the device's (a process may launch on more than one card).
template <auto KERNEL>
cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(KERNEL),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmemBytes);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Copies the block's `rows` rows of n_obs steps (y: the first row) into
// smem at the tile's pitch, and returns once they have landed for every
// thread of the block, which all call it.
__device__ __forceinline__ void stage(const float* __restrict__ y, int rows,
                                      int n_obs, const Tile& tl,
                                      float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += warps) {
    const float* src = y + static_cast<size_t>(r) * n_obs;
    float* row = smem + r * tl.pitch;
    for (int t = lane; t < n_obs; t += 32) cp_async4(row + t, src + t);
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace stage_rows
