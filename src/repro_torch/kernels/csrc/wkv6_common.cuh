// Shared pieces of the WKV6 kernels (wkv6.cu, wkv6_bwd.cu).
//
// The recurrence of one head, with S its (K, V) state (K == V here) and
// w = exp(logw):
//
//   out_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
//   S[k, v] <- w_t[k] S[k, v] + k_t[k] v_t[v]
//
// Tensors r, k, v, logw are (B, S, H, K), the model's own layout; one block
// owns one (b, h) and has K threads, one per row (or column) of the state.
// A block walks its sequence in chunks of WKV_CHUNK tokens: the threads
// stage a chunk into shared memory as float32 (thread j loads element j of
// every token, so each token row is one coalesced load; every load of the
// chunk is issued before the first store, wkv_load then wkv_store), then
// walk its tokens one by one with the state in registers.  Every thread
// reads the same staged values of a token (a broadcast), four at a time
// (16-byte loads from 16-byte aligned rows).
#pragma once

#include "common.cuh"

constexpr int WKV_CHUNK = 16;

// Four consecutive staged floats; p is 16-byte aligned.
__device__ __forceinline__ float4 wkv_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// tmp[t] = float(src[token t0 + t, element threadIdx.x]), 0 for t >= n.
template <typename T>
__device__ __forceinline__ void wkv_load(float (&tmp)[WKV_CHUNK], const T* src, size_t base, size_t row, int t0,
                                         int n) {
  const T* p = src + base + (size_t)t0 * row + threadIdx.x;
#pragma unroll
  for (int t = 0; t < WKV_CHUNK; ++t) tmp[t] = t < n ? to_float(p[(size_t)t * row]) : 0.f;
}

// dst[t][threadIdx.x] = tmp[t] (rows past the sequence's end are never read).
template <int K>
__device__ __forceinline__ void wkv_store(float (*dst)[K], const float (&tmp)[WKV_CHUNK]) {
#pragma unroll
  for (int t = 0; t < WKV_CHUNK; ++t) dst[t][threadIdx.x] = tmp[t];
}

// The decay w = exp(logw) of a staged chunk of logw.
template <int K>
__device__ __forceinline__ void wkv_store_decay(float (*dst)[K], const float (&logw)[WKV_CHUNK]) {
#pragma unroll
  for (int t = 0; t < WKV_CHUNK; ++t) dst[t][threadIdx.x] = expf(logw[t]);
}

// sum_j a[j] b[j] c[j] over one staged token.
template <int K>
__device__ __forceinline__ float wkv_dot3(const float* a, const float* b, const float* c) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) acc = fmaf(a[j] * b[j], c[j], acc);
  return acc;
}

// The forward sweep: thread v holds column v of the state in registers.
// WRITE_OUT writes out (B, S, H, V) float32; WRITE_STATES writes the state
// entering each chunk to states (B*H, n_chunks, K, V), for the backward.
// s0 (B, H, K, V) may be null (a zero state); sT, when not null, takes the
// final state.
template <typename T, int K, bool WRITE_OUT, bool WRITE_STATES>
__global__ void __launch_bounds__(K) wkv6_forward_sweep(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0, float* __restrict__ out, float* __restrict__ sT,
    float* __restrict__ states, int S, int H) {
  constexpr int C = WKV_CHUNK;
  __shared__ __align__(16) float sr[C][K];
  __shared__ __align__(16) float sk[C][K];
  __shared__ __align__(16) float sv[C][K];
  __shared__ __align__(16) float sw[C][K];
  __shared__ float su[K], sruk[C];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  su[j] = u[h * K + j];
  float st[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) st[kk] = s0 ? s0[sbase + (size_t)kk * K + j] : 0.f;
  const int nc = (S + C - 1) / C;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C, n = min(C, S - t0);
    if (WRITE_STATES) {
      float* dst = states + ((size_t)bh * nc + c) * K * K;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) dst[kk * K + j] = st[kk];
    }
    float lr[C], lk[C], lv[C], lw[C];
    wkv_load(lr, r, base, row, t0, n);
    wkv_load(lk, k, base, row, t0, n);
    wkv_load(lv, v, base, row, t0, n);
    wkv_load(lw, logw, base, row, t0, n);
    __syncthreads();  // the previous chunk is no longer read
    wkv_store<K>(sr, lr);
    wkv_store<K>(sk, lk);
    wkv_store<K>(sv, lv);
    wkv_store_decay<K>(sw, lw);
    __syncthreads();
    if (WRITE_OUT && j < n) sruk[j] = wkv_dot3<K>(sr[j], su, sk[j]);  // the bonus: sum_k r u k
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // out: sum_k r S, S before this token
#pragma unroll
      for (int kk = 0; kk < K; kk += 4) {
        const float4 w4 = wkv_ld4(&sw[t][kk]), k4 = wkv_ld4(&sk[t][kk]);
        if (WRITE_OUT) {
          const float4 r4 = wkv_ld4(&sr[t][kk]);
          a0 = fmaf(r4.x, st[kk], a0);
          a1 = fmaf(r4.y, st[kk + 1], a1);
          a2 = fmaf(r4.z, st[kk + 2], a2);
          a3 = fmaf(r4.w, st[kk + 3], a3);
        }
        st[kk] = fmaf(w4.x, st[kk], k4.x * vj);
        st[kk + 1] = fmaf(w4.y, st[kk + 1], k4.y * vj);
        st[kk + 2] = fmaf(w4.z, st[kk + 2], k4.z * vj);
        st[kk + 3] = fmaf(w4.w, st[kk + 3], k4.w * vj);
      }
      if (WRITE_OUT) out[base + (size_t)(t0 + t) * row + j] = ((a0 + a1) + (a2 + a3)) + sruk[t] * vj;
    }
  }
  if (sT) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) sT[sbase + (size_t)kk * K + j] = st[kk];
  }
}

inline bool wkv_supported_head_dim(int K) { return K == 16 || K == 32 || K == 64; }
