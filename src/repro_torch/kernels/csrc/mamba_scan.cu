// Mamba selective scan, forward, for Hopper (sm_90a):
//
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d]    = sum_n C_t[n] h_t[d, n] + D[d] x_t[d]
//
// per batch row from a zero state, returning y in x's dtype and the final
// state h_S (B, D, N) in float32.
//
// Replaces src/repro/kernels/mamba_scan.py: mamba_scan_pallas (kernel body
// _scan_kernel).  Kept from it: the discretisation happens inside the
// kernel and the state never leaves fast memory (there VMEM scratch across
// the sequential chunk grid, here registers), so the (B, S, D, N) tensors
// that the JAX training path (repro/nn/mamba.py, an associative scan)
// materialises -- 4.3 GB each per layer at the training shape -- never
// exist.  Changed: no (d_block, N) tiles walked by a sequential grid; one
// thread per (b, d) channel with its N states in registers walks the whole
// sequence, and all B * D channels run in parallel.  New: the final state,
// which the decode path of repro/nn/mamba.py carries.
//
// What bounds it on the card: at the training shape (B 16, S 512, D 8192,
// N 16, bf16 dt/x/y) it takes 1.07e9 exp, ~0.26 ms on the special function
// units (16 per clock per SM), moves ~0.40 GB (~0.12 ms at 3.35 TB/s) and
// does ~6.4e9 other float32 operations (~0.10 ms at 67 TFLOP/s): the exp
// bounds it.  131 072 threads give ~31 warps per SM to hide the sequential
// chain of each channel.
//
// A block holds MAMBA_THREADS consecutive channels of one batch row, so every
// per-token load of dt and x is one coalesced row segment.  A block walks
// its sequence in chunks of 128 / N tokens: the threads stage the chunk's
// B_t and C_t rows into shared memory, which every thread then reads (a
// broadcast), and load the chunk's dt and x into registers before the
// first use.
#include "mamba_common.cuh"

namespace {

template <int N>
constexpr int MAMBA_FWD_CHUNK = 128 / N;

// y (B, S, D) in T and, when hT is not null, the final state (B, D, N)
// float32.
template <typename T, int N>
__global__ void __launch_bounds__(MAMBA_THREADS) mamba_forward_kernel(
    const T* __restrict__ dt, const T* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv, T* __restrict__ y, float* __restrict__ hT, int S,
    int D) {
  constexpr int TC = MAMBA_FWD_CHUNK<N>;
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
  const float dd = live ? Dv[d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  const int nc = (S + TC - 1) / TC;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
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
      (&sC[0][0])[j] = Cb[(size_t)t0 * N + j];
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
          acc = fmaf(h[n], sC[i][n], acc);
        }
        if (live) y[base + (size_t)(t0 + i) * D] = from_float<T>(fmaf(dd, lx[i], acc));
      }
    }
  }
  if (hT && live) {
#pragma unroll
    for (int n = 0; n < N; ++n) hT[((size_t)b * D + d) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const float* Bm, const float* Cm, const float* A, const float* Dv, void* y,
           float* hT, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + MAMBA_THREADS - 1) / MAMBA_THREADS, B);
  mamba_forward_kernel<T, N><<<grid, MAMBA_THREADS, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), Bm, Cm, A, Dv, static_cast<T*>(y), hT, S, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int N, const void* dt, const void* x, const float* Bm, const float* Cm, const float* A, const float* Dv,
             void* y, float* hT, int B, int S, int D, cudaStream_t stream) {
  if (N == 8) return launch<T, 8>(dt, x, Bm, Cm, A, Dv, y, hT, B, S, D, stream);
  if (N == 16) return launch<T, 16>(dt, x, Bm, Cm, A, Dv, y, hT, B, S, D, stream);
  return -1;
}

}  // namespace

// dt, x (B, S, D) of dtype; Bm, Cm (B, S, N), A (D, N), Dv (D,) float32;
// y (B, S, D) of dtype and hT (B, D, N) float32.  Returns 0 or a CUDA
// error code (-1: arguments not supported).
extern "C" int mamba_scan_fwd_launch(int dtype, const void* dt, const void* x, const void* Bm, const void* Cm,
                                     const void* A, const void* Dv, void* y, void* hT, int B, int S, int D, int N,
                                     void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || !mamba_supported_state_dim(N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto bm = static_cast<const float*>(Bm);
  auto cm = static_cast<const float*>(Cm);
  auto a = static_cast<const float*>(A);
  auto dv = static_cast<const float*>(Dv);
  auto h = static_cast<float*>(hT);
  if (dtype == kFloat32) return dispatch<float>(N, dt, x, bm, cm, a, dv, y, h, B, S, D, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(N, dt, x, bm, cm, a, dv, y, h, B, S, D, s);
  return -1;
}
