// Shared pieces of the Mamba selective-scan kernels (mamba_scan.cu,
// mamba_scan_bwd.cu): the recurrence, the state dims they take, the block
// and chunk constants (the backward's mirrored in repro_torch/kernels/ops.py
// to size its scratch), the decay's exp and the chunk staging.
//
// The recurrence of one batch row b and channel d, with N states:
//
//   h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + (dt_t x_t) B_t[n]
//   y_t    = sum_n C_t[n] h_t[n] + D[d] x_t
//
// dt, x, y are (B, S, D), the model's own layout; B, C are (B, S, N)
// float32, A is (D, N) and D is (D,), both float32.
#pragma once

#include "common.cuh"

// The forward: each thread holds all N states of MAMBA_FWD_CHANNELS
// neighbouring channels in registers, so a block of MAMBA_THREADS threads
// holds MAMBA_THREADS * MAMBA_FWD_CHANNELS consecutive channels of one batch
// row; MAMBA_FWD_BLOCKS blocks an SM cap its registers at 128.  It walks the
// sequence in chunks of MAMBA_FWD_CHUNK tokens.
constexpr int MAMBA_THREADS = 128;
constexpr int MAMBA_FWD_CHANNELS = 2;
constexpr int MAMBA_FWD_BLOCKS = 4;
constexpr int MAMBA_FWD_CHUNK = 8;

// The backward: its walk gives each thread MAMBA_LANE_STATES of the N
// states of MAMBA_LANE_CHANNELS neighbouring channels, so a channel spreads
// over N / MAMBA_LANE_STATES neighbouring lanes and a block of
// MAMBA_BWD_THREADS threads holds MAMBA_BWD_THREADS * MAMBA_LANE_STATES *
// MAMBA_LANE_CHANNELS / N consecutive channels of one batch row.  It walks
// the sequence in chunks of MAMBA_BWD_CHUNK tokens and keeps the state
// entering each chunk in a scratch buffer.
constexpr int MAMBA_BWD_THREADS = 256;
constexpr int MAMBA_BWD_CHUNK = 8;
constexpr int MAMBA_LANE_STATES = 4;
constexpr int MAMBA_LANE_CHANNELS = 2;

inline bool mamba_supported_state_dim(int N) { return N == 8 || N == 16; }

// Both kernels take the decay exp(dt A) as 2^(dt a2) with a2 = A log2 e.
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

// Two neighbouring channels' values of one staged row, as floats.
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float at(const float2& v, int c) { return c == 0 ? v.x : v.y; }

// Tokens t0 .. t0 + nt - 1, channels d0 .. d0 + CH - 1 of one batch row of
// src (B, S, D) into dst[TC][CH] by the block's NT threads, zero past nt
// and D: 16-byte cp.async copies with vec (D a multiple of a copy, 16-byte
// aligned rows), else element by element.
template <int NT, int TC, typename T, int CH>
__device__ __forceinline__ void stage_rows(T (*dst)[CH], const T* src, size_t row0, int d0, int nt, int D, bool vec,
                                           int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), U = CH / E;
    for_share<NT, TC * U>(tid, [&](int e) {
      const int t = e / U, c = (e % U) * E;
      const bool in = t < nt && d0 + c < D;
      cp_async16(&dst[t][c], in ? src + row0 + (size_t)t * D + d0 + c : src, in ? 16 : 0);
    });
  } else {
    for_share<NT, TC * CH>(tid, [&](int e) {
      const int t = e / CH, c = e % CH;
      dst[t][c] = t < nt && d0 + c < D ? src[row0 + (size_t)t * D + d0 + c] : from_float<T>(0.f);
    });
  }
}

// Rows t0 .. t0 + nt - 1 of one batch row of src (B, S, N) float32 into
// dst[TC][N], zero past nt; `off` is row t0's offset.
template <int NT, int TC, int N>
__device__ __forceinline__ void stage_bc(float (*dst)[N], const float* src, size_t off, int nt, bool vec, int tid) {
  if (vec) {
    for_share<NT, TC * N / 4>(tid, [&](int e) {
      const bool in = e / (N / 4) < nt;
      cp_async16(&dst[0][0] + 4 * e, in ? src + off + 4 * e : src, in ? 16 : 0);
    });
  } else {
    for_share<NT, TC * N>(tid, [&](int e) { (&dst[0][0])[e] = e / N < nt ? src[off + e] : 0.f; });
  }
}
