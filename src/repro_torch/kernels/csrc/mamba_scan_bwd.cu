// Mamba selective scan, backward, for Hopper (sm_90a): the gradients of
// mamba_scan.cu's recurrence (the final state takes no cotangent).
//
// With a_t = exp(dt_t A), u_t = dt_t x_t, h_t the state after token t
// (h_{-1} = 0) and g_t = dL/dh_t, per batch row and channel d:
//
//   g_t       = a_{t+1} g_{t+1} + dy_t C_t          (g_S = 0)
//   q_t[n]    = g_t[n] a_t[n] h_{t-1}[n]
//   du_t      = sum_n g_t[n] B_t[n]
//   d_dt_t    = sum_n q_t[n] A[d, n] + x_t du_t
//   dx_t      = dt_t du_t + D[d] dy_t
//   dB_t[n]   = sum_d g_t[d, n] u_t[d]          (a sum over channels)
//   dC_t[n]   = sum_d dy_t[d] h_t[d, n]         (a sum over channels)
//   dA[d, n]  = sum_{b, t} q_t[n] dt_t          (a sum over rows and time)
//   dD[d]     = sum_{b, t} dy_t x_t
//
// The TPU kernel (src/repro/kernels/mamba_scan.py: mamba_scan_pallas) has
// no backward, and the JAX training path differentiates its associative
// scan by XLA.  The port needs one: the LoRA on in_proj sits before the
// scan, so every active Mamba layer's LoRA gradient flows through it.
//
// Design.  Saving every per-token state is too large (4.3 GB per layer at
// the training shape), so the forward saves only its inputs and this
// backward recomputes states:
//   1. mamba_forward_sweep writes the state entering each chunk of
//      MAMBA_CHUNK<N> tokens (8 at N 16) to a scratch buffer (B, n_chunks,
//      N, D) float32 (~0.54 GB at the training shape, freed by the caller);
//   2. one thread per (b, d) sweeps the chunks last to first: it reloads
//      the chunk's entering state, recomputes the chunk's states into
//      registers (no division: h_{t-1} = (h_t - u_t B_t) / a_t fails when
//      a_t underflows), then walks the chunk back carrying g.  d_dt and dx
//      stay inside the thread.  dA and dD are summed over the thread's
//      tokens in order; the per-token dB_t and dC_t terms are summed over
//      the warp's 32 channels by a butterfly (a reduce-scatter, lane l
//      ends with one element), over the block's warps in order through
//      shared memory, and written as per-block partials;
//   3. second passes sum the partials in order: dB, dC over the blocks of
//      channels, dA, dD over the batch rows.
// No atomics anywhere: every sum has one fixed order, so two runs give the
// same bits.
//
// What bounds it on the card: at the training shape it reads dt, x, dy
// (bf16) and writes d_dt, dx (~0.67 GB, ~0.20 ms at 3.35 TB/s); the
// function needs a_t once per state element and token (1.07e9 exp, ~0.26
// ms on the special function units) and ~19 other float32 operations per
// state element and token (the state again, g, q, the four sums; ~2.0e10,
// ~0.30 ms at 67 TFLOP/s), so the float32 operations bound it.  This kernel
// takes exp three times per element (the chunk-state sweep, the in-chunk
// recompute, the reverse) and holds 8 tokens of states per thread in
// registers, which leaves few warps per SM: a simple kernel, above that
// bound.
#include "mamba_common.cuh"

namespace {

// Butterfly reduce-scatter over a warp: v holds M values per lane; after
// it, v[0] of lane l holds the warp's sum of value l / (32 / M) of the
// original arrays.  Every addition has one fixed pair of operands.
template <int M, int O>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool upper = lane & O;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = upper ? v[j] : v[j + H];
        const float keep = upper ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<1, O / 2>(v, lane);
    }
  }
}

// The reverse sweep.  bc_part (B, n_blocks, S, 2N): dC terms in [0, N),
// dB terms in [N, 2N), summed over the block's channels; da_part (B, N, D)
// and dd_part (B, D): the thread's sums over its tokens.
template <typename T, int N>
__global__ void __launch_bounds__(MAMBA_THREADS) mamba_bwd_sweep(
    const T* __restrict__ dt, const T* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv, const T* __restrict__ dy,
    const float* __restrict__ states, T* __restrict__ d_dt, T* __restrict__ dx, float* __restrict__ bc_part,
    float* __restrict__ da_part, float* __restrict__ dd_part, int S, int D) {
  constexpr int TC = MAMBA_CHUNK<N>, W = MAMBA_THREADS / 32, SPREAD = 32 / N;
  __shared__ __align__(16) float sB[TC][N];
  __shared__ __align__(16) float sC[TC][N];
  __shared__ float sred[W][TC][2 * N];
  __shared__ float sda[N][MAMBA_THREADS];  // dA sums, one column per thread
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, tid = threadIdx.x;
  const int d = blk * MAMBA_THREADS + tid, lane = tid & 31, warp = tid >> 5;
  const bool live = d < D;  // threads past D run with zeros and store nothing
  float a[N], g[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)d * N + n] : 0.f;
    g[n] = 0.f;
    sda[n][tid] = 0.f;
  }
  const float dd = live ? Dv[d] : 0.f;
  float dd_acc = 0.f;
  const size_t base = (size_t)b * S * D + d;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  const int nc = (S + TC - 1) / TC;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
    float ldt[TC], lx[TC], ldy[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const bool ok = live && i < nt;
      const size_t at = base + (size_t)(t0 + i) * D;
      ldt[i] = ok ? to_float(dt[at]) : 0.f;
      lx[i] = ok ? to_float(x[at]) : 0.f;
      ldy[i] = ok ? to_float(dy[at]) : 0.f;
    }
    __syncthreads();  // the previous chunk's staged rows and sums are no longer read
    for (int j = tid; j < nt * N; j += MAMBA_THREADS) {
      (&sB[0][0])[j] = Bb[(size_t)t0 * N + j];
      (&sC[0][0])[j] = Cb[(size_t)t0 * N + j];
    }
    __syncthreads();
    // the chunk's states, recomputed from the one entering it
    const float* s_in = states + (size_t)(b * nc + c) * N * D + d;
    float h0[N];
#pragma unroll
    for (int n = 0; n < N; ++n) h0[n] = live ? s_in[(size_t)n * D] : 0.f;
    float hs[TC][N];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (i < nt) {
        const float u = ldt[i] * lx[i];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float prev = i == 0 ? h0[n] : hs[i - 1][n];
          hs[i][n] = fmaf(expf(ldt[i] * a[n]), prev, u * sB[i][n]);
        }
      }
    }
    // back through the chunk
#pragma unroll
    for (int i = TC - 1; i >= 0; --i) {
      if (i < nt) {
        const float dyv = ldy[i], dtv = ldt[i], xv = lx[i], u = dtv * xv;
        float vals[N];
#pragma unroll
        for (int n = 0; n < N; ++n) vals[n] = dyv * hs[i][n];  // dC_t terms
        butterfly<N, 16>(vals, lane);
        if (lane % SPREAD == 0) sred[warp][i][lane / SPREAD] = vals[0];
        float du = 0.f, sdt = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          g[n] = fmaf(dyv, sC[i][n], g[n]);  // dL/dh_t
          vals[n] = g[n] * u;                // dB_t terms
          du = fmaf(g[n], sB[i][n], du);
          const float an = expf(dtv * a[n]);
          const float q = g[n] * an * (i == 0 ? h0[n] : hs[i - 1][n]);
          sdt = fmaf(q, a[n], sdt);
          sda[n][tid] = fmaf(q, dtv, sda[n][tid]);
          g[n] = an * g[n];  // carried to token t - 1
        }
        butterfly<N, 16>(vals, lane);
        if (lane % SPREAD == 0) sred[warp][i][N + lane / SPREAD] = vals[0];
        if (live) {
          const size_t at = base + (size_t)(t0 + i) * D;
          d_dt[at] = from_float<T>(fmaf(xv, du, sdt));
          dx[at] = from_float<T>(fmaf(dtv, du, dd * dyv));
        }
        dd_acc = fmaf(dyv, xv, dd_acc);
      }
    }
    __syncthreads();
    for (int j = tid; j < nt * 2 * N; j += MAMBA_THREADS) {
      const int i = j / (2 * N), v = j % (2 * N);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) acc += sred[w][i][v];
      bc_part[(((size_t)b * nblk + blk) * S + t0 + i) * 2 * N + v] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) da_part[((size_t)b * N + n) * D + d] = sda[n][tid];
    dd_part[(size_t)b * D + d] = dd_acc;
  }
}

// dC[b, t, n], dB[b, t, n]: the partials of bc_part summed over the blocks
// of channels, in order.
__global__ void mamba_bc_reduce(const float* __restrict__ bc_part, float* __restrict__ dB, float* __restrict__ dC,
                                int B, int S, int N, int nblk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int V = 2 * N;
  if (i >= (size_t)B * S * V) return;
  const int v = i % V;
  const size_t bt = i / V, b = bt / S, t = bt % S;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k) acc += bc_part[((b * nblk + k) * S + t) * V + v];
  if (v < N)
    dC[bt * N + v] = acc;
  else
    dB[bt * N + v - N] = acc;
}

// dA[d, n] and dD[d]: the per-row partials summed over the batch, in order.
__global__ void mamba_ad_reduce(const float* __restrict__ da_part, const float* __restrict__ dd_part,
                                float* __restrict__ dA, float* __restrict__ dD, int B, int D, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t DN = (size_t)D * N;
  if (i < DN) {
    const size_t d = i / N, n = i % N;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += da_part[((size_t)b * N + n) * D + d];
    dA[i] = acc;
  } else if (i < DN + D) {
    const size_t d = i - DN;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += dd_part[(size_t)b * D + d];
    dD[d] = acc;
  }
}

struct Args {
  const void *dt, *x, *dy;
  const float *Bm, *Cm, *A, *Dv;
  void *d_dt, *dx;
  float *dB, *dC, *dA, *dD, *states, *bc_part, *da_part, *dd_part;
  int B, S, D;
};

template <typename T, int N>
int launch(const Args& a, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(a.dt);
  const T* x = static_cast<const T*>(a.x);
  const int nblk = (a.D + MAMBA_THREADS - 1) / MAMBA_THREADS;
  const dim3 grid(nblk, a.B);
  mamba_forward_sweep<T, N, false, true><<<grid, MAMBA_THREADS, 0, stream>>>(
      dt, x, a.Bm, a.Cm, a.A, a.Dv, nullptr, nullptr, a.states, a.S, a.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_bwd_sweep<T, N><<<grid, MAMBA_THREADS, 0, stream>>>(
      dt, x, a.Bm, a.Cm, a.A, a.Dv, static_cast<const T*>(a.dy), a.states, static_cast<T*>(a.d_dt),
      static_cast<T*>(a.dx), a.bc_part, a.da_part, a.dd_part, a.S, a.D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_bc = (size_t)a.B * a.S * 2 * N;
  mamba_bc_reduce<<<(unsigned)((n_bc + 255) / 256), 256, 0, stream>>>(a.bc_part, a.dB, a.dC, a.B, a.S, N, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_ad = (size_t)a.D * N + a.D;
  mamba_ad_reduce<<<(unsigned)((n_ad + 255) / 256), 256, 0, stream>>>(a.da_part, a.dd_part, a.dA, a.dD, a.B, a.D,
                                                                       N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int N, const Args& a, cudaStream_t stream) {
  if (N == 8) return launch<T, 8>(a, stream);
  if (N == 16) return launch<T, 16>(a, stream);
  return -1;
}

}  // namespace

// dt, x, dy (B, S, D) of dtype; Bm, Cm (B, S, N), A (D, N), Dv (D,)
// float32.  Writes d_dt, dx (B, S, D) of dtype and dB, dC (B, S, N), dA
// (D, N), dD (D,) float32.  Scratch, float32: states (B, ceil(S /
// MAMBA_CHUNK<N>), N, D), bc_part (B, ceil(D / MAMBA_THREADS), S, 2N),
// da_part (B, N, D), dd_part (B, D).  Returns 0 or a CUDA error code (-1:
// arguments not supported).
extern "C" int mamba_scan_bwd_launch(int dtype, const void* dt, const void* x, const void* Bm, const void* Cm,
                                     const void* A, const void* Dv, const void* dy, void* d_dt, void* dx, void* dB,
                                     void* dC, void* dA, void* dD, void* states, void* bc_part, void* da_part,
                                     void* dd_part, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || !mamba_supported_state_dim(N)) return -1;
  Args a{dt,
         x,
         dy,
         static_cast<const float*>(Bm),
         static_cast<const float*>(Cm),
         static_cast<const float*>(A),
         static_cast<const float*>(Dv),
         d_dt,
         dx,
         static_cast<float*>(dB),
         static_cast<float*>(dC),
         static_cast<float*>(dA),
         static_cast<float*>(dD),
         static_cast<float*>(states),
         static_cast<float*>(bc_part),
         static_cast<float*>(da_part),
         static_cast<float*>(dd_part),
         B,
         S,
         D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(N, a, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(N, a, s);
  return -1;
}
