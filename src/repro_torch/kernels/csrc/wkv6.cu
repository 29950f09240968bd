// WKV6 forward for Hopper (sm_90a): the RWKV6 time-mix recurrence
//
//   out_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
//   S[k, v] <- exp(logw_t[k]) S[k, v] + k_t[k] v_t[v]
//
// per (batch, head), from an optional initial state s0, returning out in
// float32 and the final state.
//
// Replaces src/repro/kernels/rwkv6_scan.py: wkv6_pallas (kernel body
// _wkv_kernel).  Kept from it: the per-head state never leaves fast memory
// (there VMEM scratch across the sequential chunk grid, here registers), so
// no (B, S, K, V) tensor exists in device memory.  Changed: the TPU kernel
// runs each 16-token chunk as matmuls through the log-decay division trick,
// which is safe only because logw is clamped to [-4, 0) (e^{16*4} inside a
// chunk); this kernel is the sequential form that the TPU kernel adapted,
// with no division and no overflow bound.  Also new: the state in (s0) and
// out (the prefill-with-state branch of repro/nn/rwkv.py), and out in
// float32, which is what the model path reads (_wkv_chunked computes in
// float32 and _group_norm follows).
//
// Design: one block per (b, h), one thread per column v of the state, the
// column (K floats) in registers; each 16-token chunk of r, k, v and logw
// lands in shared memory by cp.async while the chunk before it computes
// (wkv6_common.cuh), and is converted to float32 with w = exp(logw), where
// every thread reads the same r_t[k], k_t[k], w_t[k] (a broadcast, four
// floats per load).  Per token and state element: out += r S, S = w S + k v
// (5 operations).
//
// What bounds it on the card: at the training shape (B 16, S 512, H 40,
// K 64, bf16 r/k/v) it moves ~304 MB (r, k, v bf16; logw and out float32;
// the final state), ~91 us at 3.35 TB/s, and does 6.7e9 float32
// operations, ~100 us at 67 TFLOP/s, so operations bound it.  The
// sequential loop runs on the float32 pipes of 640 blocks of K threads,
// about 10 warps on an SM, one token after another; splitting each column
// over more threads made it slower (PERF.md), and a chunked form on the
// tensor cores is for a later change.
#include <cstdint>
#include <initializer_list>

#include "wkv6_common.cuh"

namespace {

template <typename T, int K>
struct ForwardSmem {
  WkvChunk<T, K> raw[2];
  WkvStaged<K> s;
  float u[K], ruk[WKV_CHUNK];
};

// Thread v holds column v of the state in registers.
template <typename T, int K>
__global__ void __launch_bounds__(K) wkv6_forward_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0, float* __restrict__ out, float* __restrict__ sT,
    int S, int H) {
  constexpr int C = WKV_CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  ForwardSmem<T, K>& sm = *reinterpret_cast<ForwardSmem<T, K>*>(smem);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  sm.u[j] = u[h * K + j];
  float st[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) st[kk] = s0 ? s0[sbase + (size_t)kk * K + j] : 0.f;
  const int nc = (S + C - 1) / C;
  wkv_issue_chunk<T, K>(sm.raw[0], r, k, v, logw, base, row, 0, min(C, S), j, K);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C, n = min(C, S - t0);
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the previous chunk is no longer read
    if (c + 1 < nc) wkv_issue_chunk<T, K>(sm.raw[(c + 1) & 1], r, k, v, logw, base, row, t0 + C, min(C, S - t0 - C), j, K);
    cp_async_commit();
    wkv_convert<T, K>(sm.s, sm.raw[c & 1], j, K);
    __syncthreads();
    if (j < n) sm.ruk[j] = wkv_dot3<K>(sm.s.r[j], sm.u, sm.s.k[j]);  // the bonus: sum_k r u k
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sm.s.v[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // out: sum_k r S, S before this token
#pragma unroll
      for (int kk = 0; kk < K; kk += 4) {
        const float4 w4 = wkv_ld4(&sm.s.w[t][kk]), k4 = wkv_ld4(&sm.s.k[t][kk]), r4 = wkv_ld4(&sm.s.r[t][kk]);
        a0 = fmaf(r4.x, st[kk], a0);
        a1 = fmaf(r4.y, st[kk + 1], a1);
        a2 = fmaf(r4.z, st[kk + 2], a2);
        a3 = fmaf(r4.w, st[kk + 3], a3);
        st[kk] = fmaf(w4.x, st[kk], k4.x * vj);
        st[kk + 1] = fmaf(w4.y, st[kk + 1], k4.y * vj);
        st[kk + 2] = fmaf(w4.z, st[kk + 2], k4.z * vj);
        st[kk + 3] = fmaf(w4.w, st[kk + 3], k4.w * vj);
      }
      out[base + (size_t)(t0 + t) * row + j] = ((a0 + a1) + (a2 + a3)) + sm.ruk[t] * vj;
    }
  }
  if (sT) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) sT[sbase + (size_t)kk * K + j] = st[kk];
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0, float* out,
           float* sT, int B, int S, int H, cudaStream_t stream) {
  constexpr int smem = sizeof(ForwardSmem<T, K>);
  cudaError_t err = cudaFuncSetAttribute(wkv6_forward_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_forward_kernel<T, K><<<B * H, K, smem, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                                        static_cast<const T*>(v), logw, u, s0, out, sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int K, const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0,
             float* out, float* sT, int B, int S, int H, cudaStream_t stream) {
  if (K == 16) return launch<T, 16>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  if (K == 32) return launch<T, 32>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  if (K == 64) return launch<T, 64>(r, k, v, logw, u, s0, out, sT, B, S, H, stream);
  return -1;
}

}  // namespace

// r, k, v (B, S, H, K) of dtype; logw (B, S, H, K) and u (H, K) float32;
// s0 (B, H, K, K) float32 or null; out (B, S, H, K) and sT (B, H, K, K)
// float32.  r, k, v and logw 16-byte aligned.  Returns 0 or a CUDA error
// code (-1: arguments not supported).
extern "C" int wkv6_fwd_launch(int dtype, const void* r, const void* k, const void* v, const void* logw,
                               const void* u, const void* s0, void* out, void* sT, int B, int S, int H, int K,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !wkv_supported_head_dim(K)) return -1;
  for (const void* p : {r, k, v, logw})
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto lw = static_cast<const float*>(logw);
  auto uu = static_cast<const float*>(u);
  auto s0f = static_cast<const float*>(s0);
  auto o = static_cast<float*>(out);
  auto st = static_cast<float*>(sT);
  if (dtype == kFloat32) return dispatch<float>(K, r, k, v, lw, uu, s0f, o, st, B, S, H, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(K, r, k, v, lw, uu, s0f, o, st, B, S, H, s);
  return -1;
}
