// Shared pieces of the WKV6 kernels (wkv6.cu, wkv6_bwd.cu).
//
// The recurrence of one head, with S its (K, V) state (K == V here) and
// w = exp(logw):
//
//   out_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
//   S[k, v] <- w_t[k] S[k, v] + k_t[k] v_t[v]
//
// Tensors r, k, v, logw are (B, S, H, K), the model's own layout; one block
// owns one (b, h).  A block walks its sequence in chunks of WKV_CHUNK
// tokens.  A chunk lands in shared memory as it lies in device memory, by
// 16-byte cp.async copies into one of two buffers (one token of one head
// is a K-element row at stride H * K), so the next chunk loads while this
// one computes; the threads then convert it to float32 (w = exp(logw),
// taken once per element) and walk its tokens one by one with the state in
// registers.  Every thread reads the same staged values of a token (a
// broadcast), four at a time (16-byte loads from 16-byte aligned rows).
// Every tensor the kernels copy this way must be 16-byte aligned (the
// wrapper in repro_torch/kernels/ops.py sees to it).
#pragma once

#include "common.cuh"

constexpr int WKV_CHUNK = 16;

// One chunk of r, k, v (T) and logw (float32) as it lands.
template <typename T, int K>
struct WkvChunk {
  alignas(16) T r[WKV_CHUNK][K];
  alignas(16) T k[WKV_CHUNK][K];
  alignas(16) T v[WKV_CHUNK][K];
  alignas(16) float lw[WKV_CHUNK][K];
};

// The chunk as the recurrence reads it: float32, w = exp(logw).
template <int K>
struct WkvStaged {
  alignas(16) float r[WKV_CHUNK][K];
  alignas(16) float k[WKV_CHUNK][K];
  alignas(16) float v[WKV_CHUNK][K];
  alignas(16) float w[WKV_CHUNK][K];
};

// Four consecutive staged floats; p is 16-byte aligned.
__device__ __forceinline__ float4 wkv_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// This thread's share (of NT) of the cp.async copies of tokens t0 .. t0 +
// n - 1 of one (b, h) of src into dst; rows from n on are zero-filled.
template <int NT, typename T, int K>
__device__ __forceinline__ void wkv_issue(T (*dst)[K], const T* src, size_t base, size_t row, int t0, int n,
                                          int tid) {
  constexpr int E = 16 / sizeof(T), U = K / E;  // elements per copy, copies per token
  for_share<NT, WKV_CHUNK * U>(tid, [&](int e) {
    const int t = e / U, x = (e % U) * E;
    const bool in = t < n;
    cp_async16(&dst[t][x], in ? src + base + (size_t)(t0 + t) * row + x : src, in ? 16 : 0);
  });
}

template <int NT, typename T, int K>
__device__ __forceinline__ void wkv_issue_chunk(WkvChunk<T, K>& dst, const T* r, const T* k, const T* v,
                                                const float* logw, size_t base, size_t row, int t0, int n, int tid) {
  if (r) wkv_issue<NT>(dst.r, r, base, row, t0, n, tid);  // r may be left out
  wkv_issue<NT>(dst.k, k, base, row, t0, n, tid);
  wkv_issue<NT>(dst.v, v, base, row, t0, n, tid);
  wkv_issue<NT>(dst.lw, logw, base, row, t0, n, tid);
}

// The landed chunk to float32, the decay w = exp(logw) once per element
// (r only WITH_R), by NT threads.
template <int NT, bool WITH_R = true, typename T, int K>
__device__ __forceinline__ void wkv_convert(WkvStaged<K>& dst, const WkvChunk<T, K>& src, int tid) {
  for_share<NT, WKV_CHUNK * K>(tid, [&](int e) {
    const int t = e / K, x = e % K;
    if (WITH_R) dst.r[t][x] = to_float(src.r[t][x]);
    dst.k[t][x] = to_float(src.k[t][x]);
    dst.v[t][x] = to_float(src.v[t][x]);
    dst.w[t][x] = expf(src.lw[t][x]);
  });
}

// sum_j a[j] b[j] c[j] over one staged token.
template <int K>
__device__ __forceinline__ float wkv_dot3(const float* a, const float* b, const float* c) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) acc = fmaf(a[j] * b[j], c[j], acc);
  return acc;
}

inline bool wkv_supported_head_dim(int K) { return K == 16 || K == 32 || K == 64; }
