// Shared pieces of the Mamba selective-scan kernels (mamba_scan.cu,
// mamba_scan_bwd.cu).
//
// The recurrence of one batch row b and channel d, with N states:
//
//   h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + (dt_t x_t) B_t[n]
//   y_t    = sum_n C_t[n] h_t[n] + D[d] x_t
//
// dt, x, y are (B, S, D), the model's own layout; B, C are (B, S, N)
// float32, A is (D, N) and D is (D,), both float32.  One thread owns one
// (b, d) channel and keeps its N states in registers; a block holds
// MAMBA_THREADS consecutive channels of one batch row, so every per-token
// load of dt, x (and dy) is one coalesced row segment.  A block walks its
// sequence in chunks of MAMBA_CHUNK<N> tokens: the threads stage the
// chunk's B_t (and C_t) rows into shared memory, which every thread then
// reads (a broadcast), and load the chunk's dt and x into registers before
// the first use.
#pragma once

#include "common.cuh"

constexpr int MAMBA_THREADS = 128;

// Tokens per chunk: the backward keeps a chunk's N-state history of each
// channel in registers (MAMBA_CHUNK<N> * N = 128 floats).
template <int N>
constexpr int MAMBA_CHUNK = 128 / N;

inline bool mamba_supported_state_dim(int N) { return N == 8 || N == 16; }

// The forward sweep.  WRITE_Y writes y (B, S, D) in T and, when hT is not
// null, the final state (B, D, N) float32; WRITE_STATES writes the state
// entering each chunk to states (B, n_chunks, N, D), for the backward.
template <typename T, int N, bool WRITE_Y, bool WRITE_STATES>
__global__ void __launch_bounds__(MAMBA_THREADS) mamba_forward_sweep(
    const T* __restrict__ dt, const T* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv, T* __restrict__ y, float* __restrict__ hT,
    float* __restrict__ states, int S, int D) {
  constexpr int TC = MAMBA_CHUNK<N>;
  __shared__ __align__(16) float sB[TC][N];
  __shared__ __align__(16) float sC[TC][N];
  const int b = blockIdx.y, d = blockIdx.x * MAMBA_THREADS + threadIdx.x;
  const bool live = d < D;  // threads past D run with zeros and store nothing
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = (WRITE_Y && live) ? Dv[d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  const int nc = (S + TC - 1) / TC;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
    if (WRITE_STATES && live) {
      float* dst = states + (size_t)(b * nc + c) * N * D + d;
#pragma unroll
      for (int n = 0; n < N; ++n) dst[(size_t)n * D] = h[n];
    }
    float ldt[TC], lx[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const bool ok = live && i < nt;
      ldt[i] = ok ? to_float(dt[base + (size_t)(t0 + i) * D]) : 0.f;
      lx[i] = ok ? to_float(x[base + (size_t)(t0 + i) * D]) : 0.f;
    }
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < nt * N; j += MAMBA_THREADS) {
      (&sB[0][0])[j] = Bb[(size_t)t0 * N + j];
      if (WRITE_Y) (&sC[0][0])[j] = Cb[(size_t)t0 * N + j];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (i < nt) {
        const float u = ldt[i] * lx[i];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(expf(ldt[i] * a[n]), h[n], u * sB[i][n]);
          if (WRITE_Y) acc = fmaf(h[n], sC[i][n], acc);
        }
        if (WRITE_Y && live) y[base + (size_t)(t0 + i) * D] = from_float<T>(fmaf(dd, lx[i], acc));
      }
    }
  }
  if (hT && live) {
#pragma unroll
    for (int n = 0; n < N; ++n) hT[((size_t)b * D + d) * N + n] = h[n];
  }
}
