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
// column (K floats) in registers; each 16-token chunk of r, k, v and
// w = exp(logw) is staged in shared memory, where every thread reads the
// same r_t[k], k_t[k], w_t[k] (a broadcast, four floats per load).  Per
// token and state element: out += r S, S = w S + k v (5 operations).
//
// What bounds it on the card: at the training shape (B 16, S 512, H 40,
// K 64, bf16 r/k/v) it moves ~304 MB (r, k, v bf16; logw and out float32;
// the final state), ~91 us at 3.35 TB/s, and does 6.7e9 float32
// operations, ~100 us at 67 TFLOP/s, so operations bound it.  The
// sequential loop runs on the float32 pipes of 640 blocks of K threads,
// about 10 warps on an SM, one token after another; splitting each column
// over more threads made it slower (PERF.md), and a chunked form on the
// tensor cores is for a later change.
#include "wkv6_common.cuh"

namespace {

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0, float* out,
           float* sT, int B, int S, int H, cudaStream_t stream) {
  wkv6_forward_sweep<T, K, true, false><<<B * H, K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u, s0, out, sT, nullptr, S,
      H);
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
// float32.  Returns 0 or a CUDA error code (-1: arguments not supported).
extern "C" int wkv6_fwd_launch(int dtype, const void* r, const void* k, const void* v, const void* logw,
                               const void* u, const void* s0, void* out, void* sT, int B, int S, int H, int K,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !wkv_supported_head_dim(K)) return -1;
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
