// WKV6 backward for Hopper (sm_90a): the gradients of wkv6.cu's recurrence.
//
// With S_t the state after token t (S_{-1} = s0), w_t = exp(logw_t),
// G_t = dL/dS_t (G_{S-1} = the final state's gradient, or zero) and do_t
// the gradient of out_t:
//
//   G_{t-1}    = diag(w_t) G_t + r_t do_t^T
//   dr_t[k]    = sum_v S_{t-1}[k, v] do_t[v] + u[k] k_t[k] (v_t . do_t)
//   dk_t[k]    = sum_v G_t[k, v] v_t[v]      + u[k] r_t[k] (v_t . do_t)
//   dv_t[v]    = sum_k G_t[k, v] k_t[k]      + (sum_k r_t[k] u[k] k_t[k]) do_t[v]
//   dlogw_t[k] = w_t[k] sum_v G_t[k, v] S_{t-1}[k, v]
//   du[k]      = sum_{b, t} r_t[k] k_t[k] (v_t . do_t)
//   ds0        = G_{-1}
//
// The TPU kernel (src/repro/kernels/rwkv6_scan.py: wkv6_pallas) has no
// backward: the JAX package differentiates its chunked XLA form
// (repro/nn/rwkv.py: _wkv_chunked) by autodiff.  The port needs one,
// because the gradient of every earlier layer's LoRA flows back through
// every later layer's time-mix.
//
// Design.  Saving every per-token state is too large (16 KB per token and
// head at K 64: 5.4 GB per layer at the training shape), so the forward
// saves only its inputs and this backward recomputes states:
//   1. wkv6_forward_sweep writes the state entering each 16-token chunk to
//      a scratch buffer (B*H, n_chunks, K, V) float32 (~340 MB at the
//      training shape, freed by the caller after the call);
//   2. rows: one block per (b, h), thread k holds row k of S and of G in
//      registers.  Rows are independent in both recurrences, so dr, dk and
//      dlogw (sums over v) stay inside a thread.  Chunks run last to first;
//      each chunk recomputes its states from the saved boundary state
//      (giving dr on the way), then walks back carrying G.  dlogw needs
//      S_{t-1} and G_t together, which a thread cannot hold for 16 tokens;
//      instead P_t = sum_v G_t[k, v] S_t[k, v] is computed exactly at the
//      chunk's end and stepped back with
//        dlogw_t = P_t - k_t dk'_t,   P_{t-1} = dlogw_t + r_t dr'_t
//      (dk', dr' without the bonus terms), so no chunk steps it more than
//      16 times.  The thread also sums du's terms over its tokens;
//   3. columns: one block per (b, h), thread v holds column v of G; dv (a
//      sum over k) stays inside a thread;
//   4. du: one thread per (h, k) sums the B per-block partials in order.
// No atomics anywhere: every sum has one fixed order, so two runs give the
// same bits.
//
// What bounds it on the card: at the training shape it reads r, k, v, do,
// logw once and writes dr, dk, dv, dlogw (~504 MB, ~0.15 ms at 3.35 TB/s)
// and does 12 float32 operations per state element and token (S again,
// G, dr', dk', dv; dlogw is O(K) per token), 1.6e10 in all, ~0.24 ms at
// 67 TFLOP/s: the operations bound it.  The three sweeps re-read the inputs and run on the
// float32 pipes from 640 blocks of K threads, so, like the forward, they
// run above that bound.
#include "wkv6_common.cuh"

namespace {

// Thread k holds row k of S and of G.
template <typename T, int K>
__global__ void __launch_bounds__(K) wkv6_bwd_rows(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ dout, const float* __restrict__ dsT,
    const float* __restrict__ states, T* __restrict__ dr, T* __restrict__ dk, float* __restrict__ dlogw,
    float* __restrict__ du_part, float* __restrict__ ds0, int S, int H) {
  constexpr int C = WKV_CHUNK;
  __shared__ __align__(16) float sr[C][K];
  __shared__ __align__(16) float sk[C][K];
  __shared__ __align__(16) float sv[C][K];
  __shared__ __align__(16) float sw[C][K];
  __shared__ __align__(16) float sdo[C][K];
  __shared__ float sdrp[C][K];  // dr' of each token, read back by the thread that wrote it
  __shared__ float svdo[C];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  const float uj = u[h * K + j];
  float g[K];
#pragma unroll
  for (int vv = 0; vv < K; ++vv) g[vv] = dsT ? dsT[sbase + (size_t)j * K + vv] : 0.f;
  float du_acc = 0.f;
  const int nc = (S + C - 1) / C;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, S - t0);
    float lr[C], lk[C], lv[C], ldo[C], lw[C];
    wkv_load(lr, r, base, row, t0, n);
    wkv_load(lk, k, base, row, t0, n);
    wkv_load(lv, v, base, row, t0, n);
    wkv_load(ldo, dout, base, row, t0, n);
    wkv_load(lw, logw, base, row, t0, n);
    __syncthreads();  // the previous chunk is no longer read
    wkv_store(sr, lr);
    wkv_store(sk, lk);
    wkv_store(sv, lv);
    wkv_store(sdo, ldo);
    wkv_store_decay(sw, lw);
    __syncthreads();
    if (j < n) {
      float acc = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; ++vv) acc = fmaf(sv[j][vv], sdo[j][vv], acc);
      svdo[j] = acc;
    }
    __syncthreads();
    // recompute the chunk's states from the one entering it: dr' on the way
    float st[K];
    const float* s_in = states + ((size_t)bh * nc + c) * K * K + (size_t)j * K;
#pragma unroll
    for (int vv = 0; vv < K; ++vv) st[vv] = s_in[vv];
    for (int t = 0; t < n; ++t) {
      const float kt = sk[t][j], wt = sw[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; vv += 4) {
        const float4 d4 = wkv_ld4(&sdo[t][vv]), v4 = wkv_ld4(&sv[t][vv]);
        a0 = fmaf(st[vv], d4.x, a0);
        a1 = fmaf(st[vv + 1], d4.y, a1);
        a2 = fmaf(st[vv + 2], d4.z, a2);
        a3 = fmaf(st[vv + 3], d4.w, a3);
        st[vv] = fmaf(wt, st[vv], kt * v4.x);
        st[vv + 1] = fmaf(wt, st[vv + 1], kt * v4.y);
        st[vv + 2] = fmaf(wt, st[vv + 2], kt * v4.z);
        st[vv + 3] = fmaf(wt, st[vv + 3], kt * v4.w);
      }
      sdrp[t][j] = (a0 + a1) + (a2 + a3);
    }
    float p = 0.f;  // sum_v G_t S_t at the chunk's last token
#pragma unroll
    for (int vv = 0; vv < K; ++vv) p = fmaf(g[vv], st[vv], p);
    for (int t = n - 1; t >= 0; --t) {
      const float rt = sr[t][j], kt = sk[t][j], wt = sw[t][j], vdo = svdo[t], drp = sdrp[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; vv += 4) {
        const float4 d4 = wkv_ld4(&sdo[t][vv]), v4 = wkv_ld4(&sv[t][vv]);
        a0 = fmaf(g[vv], v4.x, a0);
        a1 = fmaf(g[vv + 1], v4.y, a1);
        a2 = fmaf(g[vv + 2], v4.z, a2);
        a3 = fmaf(g[vv + 3], v4.w, a3);
        g[vv] = fmaf(wt, g[vv], rt * d4.x);  // G_{t-1}, after G_t has given dk'
        g[vv + 1] = fmaf(wt, g[vv + 1], rt * d4.y);
        g[vv + 2] = fmaf(wt, g[vv + 2], rt * d4.z);
        g[vv + 3] = fmaf(wt, g[vv + 3], rt * d4.w);
      }
      const float dkp = (a0 + a1) + (a2 + a3);
      const float dlw = p - kt * dkp;
      const size_t i = base + (size_t)(t0 + t) * row + j;
      dr[i] = from_float<T>(drp + uj * kt * vdo);
      dk[i] = from_float<T>(dkp + uj * rt * vdo);
      dlogw[i] = dlw;
      du_acc = fmaf(rt * kt, vdo, du_acc);
      p = fmaf(rt, drp, dlw);
    }
  }
  du_part[(size_t)bh * K + j] = du_acc;
  if (ds0) {
#pragma unroll
    for (int vv = 0; vv < K; ++vv) ds0[sbase + (size_t)j * K + vv] = g[vv];
  }
}

// Thread v holds column v of G.
template <typename T, int K>
__global__ void __launch_bounds__(K) wkv6_bwd_cols(
    const T* __restrict__ r, const T* __restrict__ k, const float* __restrict__ logw, const float* __restrict__ u,
    const float* __restrict__ dout, const float* __restrict__ dsT, T* __restrict__ dv, int S, int H) {
  constexpr int C = WKV_CHUNK;
  __shared__ __align__(16) float sr[C][K];
  __shared__ __align__(16) float sk[C][K];
  __shared__ __align__(16) float sw[C][K];
  __shared__ __align__(16) float sdo[C][K];
  __shared__ float su[K], sruk[C];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  su[j] = u[h * K + j];
  float g[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) g[kk] = dsT ? dsT[sbase + (size_t)kk * K + j] : 0.f;
  const int nc = (S + C - 1) / C;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, S - t0);
    float lr[C], lk[C], ldo[C], lw[C];
    wkv_load(lr, r, base, row, t0, n);
    wkv_load(lk, k, base, row, t0, n);
    wkv_load(ldo, dout, base, row, t0, n);
    wkv_load(lw, logw, base, row, t0, n);
    __syncthreads();  // the previous chunk is no longer read
    wkv_store(sr, lr);
    wkv_store(sk, lk);
    wkv_store(sdo, ldo);
    wkv_store_decay(sw, lw);
    __syncthreads();
    if (j < n) sruk[j] = wkv_dot3<K>(sr[j], su, sk[j]);
    __syncthreads();
    for (int t = n - 1; t >= 0; --t) {
      const float dot = sdo[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; kk += 4) {
        const float4 k4 = wkv_ld4(&sk[t][kk]), w4 = wkv_ld4(&sw[t][kk]), r4 = wkv_ld4(&sr[t][kk]);
        a0 = fmaf(g[kk], k4.x, a0);
        a1 = fmaf(g[kk + 1], k4.y, a1);
        a2 = fmaf(g[kk + 2], k4.z, a2);
        a3 = fmaf(g[kk + 3], k4.w, a3);
        g[kk] = fmaf(w4.x, g[kk], r4.x * dot);  // G_{t-1}, after G_t has given dv
        g[kk + 1] = fmaf(w4.y, g[kk + 1], r4.y * dot);
        g[kk + 2] = fmaf(w4.z, g[kk + 2], r4.z * dot);
        g[kk + 3] = fmaf(w4.w, g[kk + 3], r4.w * dot);
      }
      dv[base + (size_t)(t0 + t) * row + j] = from_float<T>(((a0 + a1) + (a2 + a3)) + sruk[t] * dot);
    }
  }
}

// du[h, k] = sum_b du_part[b, h, k], b in order.
__global__ void wkv6_du_reduce(const float* __restrict__ du_part, float* __restrict__ du, int B, int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * HK + i];
  du[i] = acc;
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *u, *s0, *dout, *dsT;
  void *dr, *dk, *dv;
  float *dlogw, *du, *ds0, *states, *du_part;
  int B, S, H;
};

template <typename T, int K>
int launch(const Args& a, cudaStream_t stream) {
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int blocks = a.B * a.H;
  wkv6_forward_sweep<T, K, false, true>
      <<<blocks, K, 0, stream>>>(r, k, v, a.logw, a.u, a.s0, nullptr, nullptr, a.states, a.S, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_rows<T, K><<<blocks, K, 0, stream>>>(r, k, v, a.logw, a.u, a.dout, a.dsT, a.states,
                                                 static_cast<T*>(a.dr), static_cast<T*>(a.dk), a.dlogw, a.du_part,
                                                 a.ds0, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_cols<T, K><<<blocks, K, 0, stream>>>(r, k, a.logw, a.u, a.dout, a.dsT, static_cast<T*>(a.dv), a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hk = a.H * K;
  wkv6_du_reduce<<<(hk + 255) / 256, 256, 0, stream>>>(a.du_part, a.du, a.B, hk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int K, const Args& a, cudaStream_t stream) {
  if (K == 16) return launch<T, 16>(a, stream);
  if (K == 32) return launch<T, 32>(a, stream);
  if (K == 64) return launch<T, 64>(a, stream);
  return -1;
}

}  // namespace

// r, k, v (B, S, H, K) of dtype; logw (B, S, H, K), u (H, K), dout
// (B, S, H, K) float32; s0, dsT (B, H, K, K) float32 or null.  Writes dr,
// dk, dv (dtype), dlogw (float32, like logw), du (H, K) and, when not null,
// ds0 (B, H, K, K) float32.  Scratch: states (B*H, ceil(S/16), K, K) and
// du_part (B, H, K) float32.  Returns 0 or a CUDA error code (-1: arguments
// not supported).
extern "C" int wkv6_bwd_launch(int dtype, const void* r, const void* k, const void* v, const void* logw,
                               const void* u, const void* s0, const void* dout, const void* dsT, void* dr, void* dk,
                               void* dv, void* dlogw, void* du, void* ds0, void* states, void* du_part, int B, int S,
                               int H, int K, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !wkv_supported_head_dim(K)) return -1;
  Args a{r,
         k,
         v,
         static_cast<const float*>(logw),
         static_cast<const float*>(u),
         static_cast<const float*>(s0),
         static_cast<const float*>(dout),
         static_cast<const float*>(dsT),
         dr,
         dk,
         dv,
         static_cast<float*>(dlogw),
         static_cast<float*>(du),
         static_cast<float*>(ds0),
         static_cast<float*>(states),
         static_cast<float*>(du_part),
         B,
         S,
         H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(K, a, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(K, a, s);
  return -1;
}
