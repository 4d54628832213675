// One step of the Holt-Winters recurrence and its tangents with every
// rounding written out, for hw_sse_rows_kernel (csrc/hw_sse.rows.cu).
//
// csrc/hw_sse.cu's hw_step, which the time-major hw_sse_kernel and the
// box fit run, is written as plain expressions and leaves the
// contraction into FMAs to nvcc; and nvcc's contraction of it was not a
// property of its expressions: the ring in registers (periods 4, 7, 12,
// 24) and the ring in memory (any other period) fused different products
// of the season update, and rounded most lanes apart (PERF.md §6).  Here
// each rounding is an intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, which nvcc never contracts or reorders), in the
// pattern nvcc chose for hw_sse.cu at the lane's period (REG: a register
// period), so the rows kernel computes that kernel's bits wherever its
// own ring lives.  The two patterns differ only in the season update:
// g sw + (1 - g) s fuses g sw with the ring in registers and (1 - g) s
// with the ring in memory.  A multiplicative dense pass leaves x - base s
// unfused where the ragged pass fuses it.

#pragma once

#include <cuda_runtime.h>

namespace hw {

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_(float a, float b) {
  return __fsub_rn(a, b);
}

// A pass's smoothing parameters and their complements, rounded once.
struct Smoothing {
  float a, b, g, oma, omb, omg;
  __device__ __forceinline__ Smoothing(float a_, float b_, float g_)
      : a(a_), b(b_), g(g_), oma(sub_(1.0f, a_)), omb(sub_(1.0f, b_)),
        omg(sub_(1.0f, g_)) {}
};

// One step of the recurrence and its tangents on one ring slot (s, ds),
// rounded as hw_sse.cu's ring in registers (REG) or in memory.
template <bool ADD, bool RAGGED, bool REG>
__device__ __forceinline__ void hw_step(
    const float x, const float w, const Smoothing& p, float& level,
    float& trend, float (&dl)[3], float (&db)[3], float& s, float (&ds)[3],
    float& sse, float (&grad)[3]) {
  const float a = p.a, b = p.b, g = p.g;
  const float oma = p.oma, omb = p.omb, omg = p.omg;
  const float base = add_(level, trend);
  float dbase[3], de[3], dlw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dbase[j] = add_(dl[j], db[j]);
  float e, lw;
  if (ADD) {
    e = sub_(x, add_(base, s));
#pragma unroll
    for (int j = 0; j < 3; ++j) de[j] = -add_(dbase[j], ds[j]);
    lw = sub_(x, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) dlw[j] = -ds[j];
  } else {
    e = RAGGED ? fma_(-base, s, x) : sub_(x, mul_(base, s));
#pragma unroll
    for (int j = 0; j < 3; ++j)
      de[j] = -fma_(dbase[j], s, mul_(base, ds[j]));
    lw = __fdiv_rn(x, s);
    const float x_s2 = __fdiv_rn(x, mul_(s, s));
#pragma unroll
    for (int j = 0; j < 3; ++j) dlw[j] = mul_(-x_s2, ds[j]);
  }
  // a lw + (1 - a) base
  const float nl = fma_(oma, base, mul_(a, lw));
  float dnl[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dnl[j] = fma_(oma, dbase[j], mul_(a, dlw[j]));
  dnl[0] = add_(dnl[0], sub_(lw, base));
  // b (nl - level) + (1 - b) trend
  const float step = sub_(nl, level);
  const float nt = fma_(omb, trend, mul_(b, step));
  float dnt[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dnt[j] = fma_(b, sub_(dnl[j], dl[j]), mul_(omb, db[j]));
  dnt[1] = add_(dnt[1], sub_(step, trend));
  float sw, dsw[3];
  if (ADD) {
    sw = sub_(x, nl);
#pragma unroll
    for (int j = 0; j < 3; ++j) dsw[j] = -dnl[j];
  } else {
    sw = __fdiv_rn(x, nl);
    const float x_l2 = __fdiv_rn(x, mul_(nl, nl));
#pragma unroll
    for (int j = 0; j < 3; ++j) dsw[j] = mul_(-x_l2, dnl[j]);
  }
  // g sw + (1 - g) s
  float dns[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) dns[j] = fma_(omg, ds[j], mul_(g, dsw[j]));
  dns[2] = add_(dns[2], sub_(sw, s));
  s = REG ? fma_(g, sw, mul_(omg, s)) : fma_(omg, s, mul_(g, sw));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ds[j] = dns[j];
    dl[j] = dnl[j];
    db[j] = dnt[j];
  }
  level = nl;
  trend = nt;
  if (RAGGED) {
    e = mul_(e, w);
#pragma unroll
    for (int j = 0; j < 3; ++j) de[j] = mul_(de[j], w);
  }
  sse = fma_(e, e, sse);
  const float e2 = add_(e, e);  // 2 e, exactly
#pragma unroll
  for (int j = 0; j < 3; ++j) grad[j] = fma_(e2, de[j], grad[j]);
}

// The step weight of a ragged lane: 1 while m + t < nv, then 0.
template <bool RAGGED>
__device__ __forceinline__ float step_weight(int m_plus_t, float n_valid) {
  return RAGGED && !(static_cast<float>(m_plus_t) < n_valid) ? 0.0f : 1.0f;
}

}  // namespace hw
