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
// saves only its inputs and this backward recomputes states, in three
// launches, each walking one (b, h) per block, its 16-token chunks staged
// by cp.async while the chunk before computes (wkv6_common.cuh):
//   1. wkv6_bwd_sweep_kernel runs the recurrence forward, thread k holding
//      row k of S.  On the way it computes dr'_t = S_{t-1} do_t (a sum over
//      v inside a thread) and writes dr = dr' + u k (v . do), keeps dr' in
//      dlogw's buffer for step 2, and writes the state leaving each chunk to
//      a scratch buffer (B*H, n_chunks, V, K) float32 (~335 MB at the
//      training shape, freed by the caller after the call);
//   2. wkv6_bwd_fused_kernel walks the chunks last to first with 2K
//      threads, both halves reading one staging of the chunk:
//      - threads 0 .. K-1 (rows): thread k holds row k of G.  Rows are
//        independent in the recurrence of G, so dk and dlogw (sums over v)
//        stay inside a thread.  dlogw needs S_{t-1} and G_t together, which
//        a thread does not hold; instead P_t = sum_v G_t[k, v] S_t[k, v] is
//        computed exactly from the saved state at the chunk's end and
//        stepped back with
//          dlogw_t = P_t - k_t dk'_t,   P_{t-1} = dlogw_t + r_t dr'_t
//        (dk', dr' without the bonus terms), so no chunk steps it more than
//        16 times.  The thread also sums du's terms over its tokens;
//      - threads K .. 2K-1 (columns): thread v holds column v of G; dv (a
//        sum over k) stays inside a thread.
//      w = exp(logw) is taken once per element and step;
//   3. wkv6_du_reduce_kernel: one thread per (h, k) sums the B per-block
//      partials in order.
// No atomics anywhere: every sum has one fixed order, so two runs give the
// same bits.
//
// What bounds it on the card: at the training shape it reads r, k, v, do,
// logw once and writes dr, dk, dv, dlogw (~504 MB, ~0.15 ms at 3.35 TB/s)
// and does 12 float32 operations per state element and token (S again, G,
// dr', dk', dv; dlogw is O(K) per token), 1.6e10 in all, ~0.24 ms at 67
// TFLOP/s: the operations bound it.  The kernels also move the states (335
// MB written, then read), dr' (84 MB written, then read) and read k, v,
// logw and do twice: ~1.6 GB, ~0.48 ms of bytes.  The three launches split
// the float32 work evenly, three FMA-pipe instructions per state element
// and token each for the sweep, the rows and the columns.
#include <cstdint>
#include <initializer_list>

#include "wkv6_common.cuh"

namespace {

template <typename T, int K>
struct SweepSmem {
  WkvChunk<T, K> raw[2];  // r is not staged
  alignas(16) float dout[2][WKV_CHUNK][K];
  WkvStaged<K> s;  // r is not converted
  float vdo[WKV_CHUNK];
};

// Step 1: thread k holds row k of S, from s0 (or zero).
template <typename T, int K>
__global__ void __launch_bounds__(K) wkv6_bwd_sweep_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw, const float* __restrict__ u,
    const float* __restrict__ s0, const float* __restrict__ dout, float* __restrict__ states, T* __restrict__ dr,
    float* __restrict__ drp_out, int S, int H) {
  constexpr int C = WKV_CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  SweepSmem<T, K>& sm = *reinterpret_cast<SweepSmem<T, K>*>(smem);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  const float uj = u[h * K + j];
  float st[K];
#pragma unroll
  for (int vv = 0; vv < K; ++vv) st[vv] = s0 ? s0[sbase + (size_t)j * K + vv] : 0.f;
  const int nc = (S + C - 1) / C;
  wkv_issue_chunk<K>(sm.raw[0], static_cast<const T*>(nullptr), k, v, logw, base, row, 0, min(C, S), j);
  wkv_issue<K>(sm.dout[0], dout, base, row, 0, min(C, S), j);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * C, n = min(C, S - t0), buf = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the previous chunk is no longer read
    if (c + 1 < nc) {
      wkv_issue_chunk<K>(sm.raw[buf ^ 1], static_cast<const T*>(nullptr), k, v, logw, base, row, t0 + C,
                         min(C, S - t0 - C), j);
      wkv_issue<K>(sm.dout[buf ^ 1], dout, base, row, t0 + C, min(C, S - t0 - C), j);
    }
    cp_async_commit();
    wkv_convert<K, false>(sm.s, sm.raw[buf], j);
    __syncthreads();
    const float(*sdo)[K] = sm.dout[buf];
    if (j < n) {
      float acc = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; ++vv) acc = fmaf(sm.s.v[j][vv], sdo[j][vv], acc);
      sm.vdo[j] = acc;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float kt = sm.s.k[t][j], wt = sm.s.w[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; vv += 4) {
        const float4 d4 = wkv_ld4(&sdo[t][vv]), v4 = wkv_ld4(&sm.s.v[t][vv]);
        a0 = fmaf(st[vv], d4.x, a0);
        a1 = fmaf(st[vv + 1], d4.y, a1);
        a2 = fmaf(st[vv + 2], d4.z, a2);
        a3 = fmaf(st[vv + 3], d4.w, a3);
        st[vv] = fmaf(wt, st[vv], kt * v4.x);
        st[vv + 1] = fmaf(wt, st[vv + 1], kt * v4.y);
        st[vv + 2] = fmaf(wt, st[vv + 2], kt * v4.z);
        st[vv + 3] = fmaf(wt, st[vv + 3], kt * v4.w);
      }
      const float drp = (a0 + a1) + (a2 + a3);
      const size_t i = base + (size_t)(t0 + t) * row + j;
      dr[i] = from_float<T>(drp + uj * kt * sm.vdo[t]);
      drp_out[i] = drp;
    }
    float* dst = states + ((size_t)bh * nc + c) * K * K + j;  // the state leaving chunk c, [v][k]
#pragma unroll
    for (int vv = 0; vv < K; ++vv) dst[(size_t)vv * K] = st[vv];
  }
}

template <typename T, int K>
struct FusedSmem {
  WkvChunk<T, K> raw[2];
  alignas(16) float dout[2][WKV_CHUNK][K];  // lands as float32 and is read as it lies
  alignas(16) float drp[2][WKV_CHUNK][K];   // dr' from step 1, likewise
  alignas(16) float st[K * K];              // the state leaving the chunk, [v][k]
  WkvStaged<K> s;
  float u[K], vdo[WKV_CHUNK], ruk[WKV_CHUNK];
};

// Step 2: threads 0 .. K-1 hold rows of G, threads K .. 2K-1 columns.  Three
// blocks an SM at K 64; below it one, so that ptxas keeps every value in
// registers (with the default budget it spilled at K 32 in float32).
template <typename T, int K>
__global__ void __launch_bounds__(2 * K, K == 64 ? 3 : 1) wkv6_bwd_fused_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ dout, const float* __restrict__ dsT,
    const float* __restrict__ states, T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dlogw,
    float* __restrict__ du_part, float* __restrict__ ds0, int S, int H) {
  constexpr int C = WKV_CHUNK, NT = 2 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  FusedSmem<T, K>& sm = *reinterpret_cast<FusedSmem<T, K>*>(smem);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const bool rows = tid < K;
  const int j = rows ? tid : tid - K;  // row k, or column v
  const size_t row = (size_t)H * K, base = (size_t)b * S * row + (size_t)h * K, sbase = (size_t)bh * K * K;
  if (rows) sm.u[j] = u[h * K + j];
  const float uj = u[h * K + j];
  float g[K];  // row j of G (rows), or column j (columns)
#pragma unroll
  for (int x = 0; x < K; ++x) g[x] = dsT ? dsT[sbase + (rows ? (size_t)j * K + x : (size_t)x * K + j)] : 0.f;
  float du_acc = 0.f;
  const int nc = (S + C - 1) / C;
  auto issue = [&](int c) {  // chunk c's inputs and dr' into buffer c & 1
    const int t0 = c * C, n = min(C, S - t0);
    wkv_issue_chunk<NT>(sm.raw[c & 1], r, k, v, logw, base, row, t0, n, tid);
    wkv_issue<NT>(sm.dout[c & 1], dout, base, row, t0, n, tid);
    wkv_issue<NT>(sm.drp[c & 1], dlogw, base, row, t0, n, tid);
  };
  auto issue_state = [&](int c) {
    const float* src = states + ((size_t)bh * nc + c) * K * K;
    for (int e = tid; e < K * K / 4; e += NT) cp_async16(sm.st + 4 * e, src + 4 * e, 16);
  };
  issue(nc - 1);
  issue_state(nc - 1);
  cp_async_commit();
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, n = min(C, S - t0), buf = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c and its state have landed; chunk c + 1 is no longer read
    if (c > 0) {      // into the buffers chunk c + 1 used
      issue(c - 1);
      cp_async_commit();
    }
    float p = 0.f;  // rows: sum_v G_t S_t at the chunk's last token
    if (rows) {
#pragma unroll
      for (int vv = 0; vv < K; ++vv) p = fmaf(g[vv], sm.st[vv * K + j], p);
    }
    wkv_convert<NT>(sm.s, sm.raw[buf], tid);
    __syncthreads();  // the staged chunk is complete; every row thread has read the state
    if (c > 0) {
      issue_state(c - 1);
      cp_async_commit();
    }
    const float(*sdo)[K] = sm.dout[buf];
    if (tid < n) {
      float acc = 0.f;
#pragma unroll
      for (int vv = 0; vv < K; ++vv) acc = fmaf(sm.s.v[tid][vv], sdo[tid][vv], acc);
      sm.vdo[tid] = acc;
    } else if (!rows && j < n) {
      sm.ruk[j] = wkv_dot3<K>(sm.s.r[j], sm.u, sm.s.k[j]);
    }
    __syncthreads();
    if (rows) {
      for (int t = n - 1; t >= 0; --t) {
        const float rt = sm.s.r[t][j], kt = sm.s.k[t][j], wt = sm.s.w[t][j], vdo = sm.vdo[t], drp = sm.drp[buf][t][j];
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int vv = 0; vv < K; vv += 4) {
          const float4 d4 = wkv_ld4(&sdo[t][vv]), v4 = wkv_ld4(&sm.s.v[t][vv]);
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
        dk[i] = from_float<T>(dkp + uj * rt * vdo);
        dlogw[i] = dlw;  // over dr', which this chunk has staged
        du_acc = fmaf(rt * kt, vdo, du_acc);
        p = fmaf(rt, drp, dlw);
      }
    } else {
      for (int t = n - 1; t >= 0; --t) {
        const float dot = sdo[t][j];
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int kk = 0; kk < K; kk += 4) {
          const float4 k4 = wkv_ld4(&sm.s.k[t][kk]), w4 = wkv_ld4(&sm.s.w[t][kk]), r4 = wkv_ld4(&sm.s.r[t][kk]);
          a0 = fmaf(g[kk], k4.x, a0);
          a1 = fmaf(g[kk + 1], k4.y, a1);
          a2 = fmaf(g[kk + 2], k4.z, a2);
          a3 = fmaf(g[kk + 3], k4.w, a3);
          g[kk] = fmaf(w4.x, g[kk], r4.x * dot);  // G_{t-1}, after G_t has given dv
          g[kk + 1] = fmaf(w4.y, g[kk + 1], r4.y * dot);
          g[kk + 2] = fmaf(w4.z, g[kk + 2], r4.z * dot);
          g[kk + 3] = fmaf(w4.w, g[kk + 3], r4.w * dot);
        }
        dv[base + (size_t)(t0 + t) * row + j] = from_float<T>(((a0 + a1) + (a2 + a3)) + sm.ruk[t] * dot);
      }
    }
  }
  if (rows) {
    du_part[(size_t)bh * K + j] = du_acc;
    if (ds0) {
#pragma unroll
      for (int vv = 0; vv < K; ++vv) ds0[sbase + (size_t)j * K + vv] = g[vv];
    }
  }
}

// du[h, k] = sum_b du_part[b, h, k], b in order.
__global__ void wkv6_du_reduce_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int HK) {
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
  constexpr int sweep_smem = sizeof(SweepSmem<T, K>), fused_smem = sizeof(FusedSmem<T, K>);
  cudaError_t err =
      cudaFuncSetAttribute(wkv6_bwd_sweep_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, sweep_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_sweep_kernel<T, K><<<blocks, K, sweep_smem, stream>>>(k, v, a.logw, a.u, a.s0, a.dout, a.states,
                                                                  static_cast<T*>(a.dr), a.dlogw, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv6_bwd_fused_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, fused_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_fused_kernel<T, K><<<blocks, 2 * K, fused_smem, stream>>>(
      r, k, v, a.logw, a.u, a.dout, a.dsT, a.states, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dlogw, a.du_part,
      a.ds0, a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hk = a.H * K;
  wkv6_du_reduce_kernel<<<(hk + 255) / 256, 256, 0, stream>>>(a.du_part, a.du, a.B, hk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int smem_bytes(bool fused) {
  return fused ? static_cast<int>(sizeof(FusedSmem<T, K>)) : static_cast<int>(sizeof(SweepSmem<T, K>));
}

template <typename T>
int smem_bytes(int K, bool fused) {
  if (K == 16) return smem_bytes<T, 16>(fused);
  if (K == 32) return smem_bytes<T, 32>(fused);
  if (K == 64) return smem_bytes<T, 64>(fused);
  return -1;
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
// du_part (B, H, K) float32; dlogw holds dr' between the first two kernels.
// r, k, v, logw, dout, dlogw and states 16-byte aligned.  Returns 0 or a
// CUDA error code (-1: arguments not supported).
extern "C" int wkv6_bwd_launch(int dtype, const void* r, const void* k, const void* v, const void* logw,
                               const void* u, const void* s0, const void* dout, const void* dsT, void* dr, void* dk,
                               void* dv, void* dlogw, void* du, void* ds0, void* states, void* du_part, int B, int S,
                               int H, int K, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || !wkv_supported_head_dim(K)) return -1;
  for (const void* p : {r, k, v, logw, dout, static_cast<const void*>(dlogw), static_cast<const void*>(states)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return -1;
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

// Dynamic shared memory of the fused kernel (fused != 0) or of the sweep at
// (dtype, K), for reports; -1 for arguments not supported.
extern "C" int wkv6_bwd_smem_bytes(int dtype, int K, int fused) {
  if (dtype == kFloat32) return smem_bytes<float>(K, fused);
  if (dtype == kBFloat16) return smem_bytes<__nv_bfloat16>(K, fused);
  return -1;
}
