// Shared pieces of the Mamba selective-scan kernels (mamba_scan.cu,
// mamba_scan_bwd.cu): the recurrence, the state dims they take, and the
// block and chunk constants that repro_torch/kernels/ops.py mirrors to size
// the backward's scratch.
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

// The forward: one thread per (b, d) channel with its N states in
// registers, MAMBA_THREADS consecutive channels of one batch row a block.
constexpr int MAMBA_THREADS = 128;

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
