// Mamba selective scan, forward, for Hopper (sm_90a):
//
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] x_t[d]) B_t[n]
//   y_t[d]    = sum_n C_t[n] h_t[d, n] + D[d] x_t[d]
//
// per batch row from the entering state h0 (B, D, N) float32, or from zero
// where h0 is null, returning y in x's dtype and the final state h_S (B, D,
// N) in float32.
//
// Replaces src/repro/kernels/mamba_scan.py: mamba_scan_pallas (kernel body
// _scan_kernel).  Kept from it: the discretisation happens inside the
// kernel and the state never leaves fast memory (there VMEM scratch across
// the sequential chunk grid, here registers), so the (B, S, D, N) tensors
// that the JAX training path (repro/nn/mamba.py, an associative scan)
// materialises -- 4.3 GB each per layer at the training shape -- never
// exist.  Changed: no (d_block, N) tiles walked by a sequential grid; each
// thread holds all N states of MAMBA_FWD_CHANNELS (2) neighbouring channels
// of one batch row in registers and walks the whole sequence, and all
// channels of all rows run in parallel.  New: the entering and the final
// state, which the decode path of repro/nn/mamba.py carries (prefill from
// the cache's state, then one token a step, S = 1).  A thread loads its
// channels' N entering states once, before the walk, as 16-byte words
// (each read by that thread alone), so h0 adds no register to the walk.
// Whether it starts from h0 is a template argument, so the zero-state
// instantiation, which training runs, compiles to the code without h0: a
// run-time branch there spilled more and slowed the training forward
// (PERF.md).
//
// What bounds it on the card: at the training shape (B 16, S 512, D 8192,
// N 16, bf16 dt/x/y) it takes 1.07e9 exp, ~0.26 ms on the special function
// units at their listed 16 a clock per SM, moves ~0.40 GB (~0.12 ms at
// 3.35 TB/s) and does ~6.4e9 other float32 operations (~0.10 ms at 67
// TFLOP/s): the exp bounds it.  So a decay is one multiply and one
// ex2.approx of dt * A log2 e (no accurate expf, whose range reduction
// issued ~8 more instructions an element), and a state element issues ~5
// instructions: the multiply, the exp, u B_t, the state's fma and y's fma;
// the staged B_t, C_t and a2 = A log2 e values come four to a shared-memory
// load.  Measured on the H100 (PERF.md), the special function units and the
// issue of the float32 work bind together, near 0.36 ms: a second exp an
// element costs as much again, and taking a share of the exps by a
// polynomial on the FMA pipe gains nothing.
//
// Occupancy: 128 threads hold 256 channels, capped at 128 registers
// (MAMBA_FWD_BLOCKS, 4 blocks an SM, 16 warps; 42 KB of shared memory a
// block in bf16, while float32's 66 KB fit 3), so the training shape's 512
// blocks fill 528 slots on 132 SMs: one wave, where a partial second wave
// would cost a whole walk of S tokens.  A thread's 32 independent state
// chains hide the exp's and the fma's latency (32 warps an SM, one channel a
// thread, ran no faster).  a2 sits in shared memory, each thread's values
// read by that thread alone: held in registers it pushed the 128-register
// cap into spills and cost ~10%.
//
// A block walks its sequence in chunks of MAMBA_FWD_CHUNK (8) tokens.  The
// next chunk's dt and x rows (the block's channels, one coalesced segment
// a token) and its B_t, C_t rows land in shared memory by 16-byte cp.async
// while the current chunk computes (element by element when D is no whole
// 16-byte row or a pointer is unaligned), and a chunk's y leaves through
// shared memory as 16-byte rows while the next chunk computes: one barrier
// a chunk.  Tokens past S stage as zeros (a decay of 1, no input), so the
// state carries through them unchanged.  y's sum over n runs in one fixed
// order, n = 0 .. N - 1, then D x: a row gives the same bits alone and in a
// batch.  No atomics.
#include <cstdint>
#include <initializer_list>

#include "mamba_common.cuh"

namespace {

constexpr int NT = MAMBA_THREADS, CL = MAMBA_FWD_CHANNELS, TC = MAMBA_FWD_CHUNK, CH = NT * CL;

// One chunk of the block's CH channels as it lands, zero past S and D.
template <typename T, int N>
struct FwdChunk {
  alignas(16) T dt[TC][CH];
  alignas(16) T x[TC][CH];
  alignas(16) float B[TC][N];
  alignas(16) float C[TC][N];
};

template <typename T, int N>
struct FwdSmem {
  FwdChunk<T, N> buf[2];
  alignas(16) T y[2][TC][CH];
  float4 a2[CL][N / 4][NT];  // A log2 e of each thread's channels, four states a float4, read by that thread alone
};

// Two neighbouring channels' y into a staged row.
__device__ __forceinline__ void st2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// y (B, S, D) in T and, when hT is not null, the final state (B, D, N)
// float32, from the entering state h0 (B, D, N) float32 where FROM_H0, else
// from zero.  Thread tid holds channels d0 + 2 tid and d0 + 2 tid + 1.
template <typename T, int N, bool FROM_H0>
__global__ void __launch_bounds__(NT, MAMBA_FWD_BLOCKS) mamba_scan_fwd_kernel(
    const T* __restrict__ dt, const T* __restrict__ x, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dv, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hT, int S, int D, bool vec) {
  static_assert(CL == 2 && N % 4 == 0, "a thread's channels travel as pairs, its states as float4s");
  extern __shared__ __align__(16) unsigned char smem[];
  FwdSmem<T, N>& sm = *reinterpret_cast<FwdSmem<T, N>*>(smem);
  const int tid = threadIdx.x, b = blockIdx.y, d0 = blockIdx.x * CH, dp = d0 + CL * tid;
  bool live[CL];
  float h[CL][N], dd[CL];
#pragma unroll
  for (int k = 0; k < CL; ++k) {
    live[k] = dp + k < D;  // channels past D run with zeros and store nothing
#pragma unroll
    for (int n = 0; n < N; ++n) {
      (&sm.a2[k][n / 4][tid].x)[n % 4] = live[k] ? A[(size_t)(dp + k) * N + n] * kLog2e : 0.f;
      h[k][n] = 0.f;
    }
    dd[k] = live[k] ? Dv[dp + k] : 0.f;
  }
  if constexpr (FROM_H0) {  // the entering state, four states a float4 (a row of N is whole 16-byte words)
#pragma unroll
    for (int k = 0; k < CL; ++k) {
      if (!live[k]) continue;
      const float4* src = reinterpret_cast<const float4*>(h0 + ((size_t)b * D + dp + k) * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 v = src[q];
        h[k][4 * q] = v.x;
        h[k][4 * q + 1] = v.y;
        h[k][4 * q + 2] = v.z;
        h[k][4 * q + 3] = v.w;
      }
    }
  }
  const int nc = (S + TC - 1) / TC;
  auto stage = [&](int c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
    const size_t row0 = ((size_t)b * S + t0) * D, bc0 = ((size_t)b * S + t0) * N;
    FwdChunk<T, N>& dst = sm.buf[c & 1];
    stage_rows<NT, TC>(dst.dt, dt, row0, d0, nt, D, vec, tid);
    stage_rows<NT, TC>(dst.x, x, row0, d0, nt, D, vec, tid);
    stage_bc<NT, TC, N>(dst.B, Bm, bc0, nt, vec, tid);
    stage_bc<NT, TC, N>(dst.C, Cm, bc0, nt, vec, tid);
    cp_async_commit();
  };
  // chunk c's y rows from shared memory to y, rows past S and channels
  // past D left out
  auto emit = [&](int c) {
    const int t0 = c * TC, nt = min(TC, S - t0);
    const size_t row0 = ((size_t)b * S + t0) * D;
    const T(*src)[CH] = sm.y[c & 1];
    if (vec) {
      constexpr int E = 16 / sizeof(T), U = CH / E;
      for_share<NT, TC * U>(tid, [&](int e) {
        const int t = e / U, k = (e % U) * E;
        if (t < nt && d0 + k < D)
          *reinterpret_cast<uint4*>(y + row0 + (size_t)t * D + d0 + k) = *reinterpret_cast<const uint4*>(&src[t][k]);
      });
    } else {
      for_share<NT, TC * CH>(tid, [&](int e) {
        const int t = e / CH, k = e % CH;
        if (t < nt && d0 + k < D) y[row0 + (size_t)t * D + d0 + k] = src[t][k];
      });
    }
  };
  stage(0);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; chunk c - 1's rows are no longer read and its y is whole
    if (c + 1 < nc) stage(c + 1);
    if (c > 0) emit(c - 1);
    const FwdChunk<T, N>& ck = sm.buf[c & 1];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const float2 dtv = ld2(&ck.dt[i][CL * tid]), xv = ld2(&ck.x[i][CL * tid]);
      float u[CL], acc[CL];
#pragma unroll
      for (int k = 0; k < CL; ++k) {
        u[k] = at(dtv, k) * at(xv, k);
        acc[k] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bv = ld4(&ck.B[i][4 * q]), cv = ld4(&ck.C[i][4 * q]);
        const float4 av[CL] = {sm.a2[0][q][tid], sm.a2[1][q][tid]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k < CL; ++k) {
            const int n = 4 * q + j;
            h[k][n] = fmaf(exp2_approx(at(dtv, k) * at(av[k], j)), h[k][n], u[k] * at(bv, j));
            acc[k] = fmaf(h[k][n], at(cv, j), acc[k]);
          }
        }
      }
      st2(&sm.y[c & 1][i][CL * tid], fmaf(dd[0], at(xv, 0), acc[0]), fmaf(dd[1], at(xv, 1), acc[1]));
    }
  }
  __syncthreads();  // the last chunk's y is whole
  emit(nc - 1);
  if (hT) {
#pragma unroll
    for (int k = 0; k < CL; ++k) {
      if (!live[k]) continue;
      float* dst = hT + ((size_t)b * D + dp + k) * N;
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(h[k][4 * q], h[k][4 * q + 1], h[k][4 * q + 2], h[k][4 * q + 3]);
    }
  }
}

template <typename T, int N>
constexpr int smem_bytes() {
  return sizeof(FwdSmem<T, N>);
}

template <typename T, int N, bool FROM_H0>
int launch(const void* dt, const void* x, const float* Bm, const float* Cm, const float* A, const float* Dv,
           const float* h0, void* y, float* hT, int B, int S, int D, cudaStream_t stream) {
  bool vec = D % (16 / sizeof(T)) == 0;
  for (const void* p : {dt, x, (const void*)Bm, (const void*)Cm, (const void*)y})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  constexpr int smem = smem_bytes<T, N>();
  cudaError_t err =
      cudaFuncSetAttribute(mamba_scan_fwd_kernel<T, N, FROM_H0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + CH - 1) / CH, B);
  mamba_scan_fwd_kernel<T, N, FROM_H0><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x), Bm, Cm, A, Dv, h0, static_cast<T*>(y), hT, S, D, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FROM_H0>
int dispatch(int N, const void* dt, const void* x, const float* Bm, const float* Cm, const float* A, const float* Dv,
             const float* h0, void* y, float* hT, int B, int S, int D, cudaStream_t stream) {
  if (N == 8) return launch<T, 8, FROM_H0>(dt, x, Bm, Cm, A, Dv, h0, y, hT, B, S, D, stream);
  if (N == 16) return launch<T, 16, FROM_H0>(dt, x, Bm, Cm, A, Dv, h0, y, hT, B, S, D, stream);
  return -1;
}

template <typename T>
int dispatch(int N, const void* dt, const void* x, const float* Bm, const float* Cm, const float* A, const float* Dv,
             const float* h0, void* y, float* hT, int B, int S, int D, cudaStream_t stream) {
  return h0 ? dispatch<T, true>(N, dt, x, Bm, Cm, A, Dv, h0, y, hT, B, S, D, stream)
            : dispatch<T, false>(N, dt, x, Bm, Cm, A, Dv, h0, y, hT, B, S, D, stream);
}

// Blocks of the forward kernel (the zero-state instantiation) resident on
// one SM, as the runtime counts them from its registers and shared memory.
template <typename T, int N>
int blocks_per_sm() {
  constexpr int smem = smem_bytes<T, N>();
  cudaError_t err =
      cudaFuncSetAttribute(mamba_scan_fwd_kernel<T, N, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mamba_scan_fwd_kernel<T, N, false>, NT, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Dynamic shared memory of the forward kernel at state dim N, or -1.
extern "C" int mamba_scan_fwd_smem_bytes(int dtype, int N) {
  if (!mamba_supported_state_dim(N) || (dtype != kFloat32 && dtype != kBFloat16)) return -1;
  if (dtype == kFloat32) return N == 8 ? smem_bytes<float, 8>() : smem_bytes<float, 16>();
  return N == 8 ? smem_bytes<__nv_bfloat16, 8>() : smem_bytes<__nv_bfloat16, 16>();
}

// Blocks of the forward kernel an SM holds at state dim N (a CUDA error
// code negated on failure, -1: arguments not supported).
extern "C" int mamba_scan_fwd_blocks_per_sm(int dtype, int N) {
  if (!mamba_supported_state_dim(N) || (dtype != kFloat32 && dtype != kBFloat16)) return -1;
  if (dtype == kFloat32) return N == 8 ? blocks_per_sm<float, 8>() : blocks_per_sm<float, 16>();
  return N == 8 ? blocks_per_sm<__nv_bfloat16, 8>() : blocks_per_sm<__nv_bfloat16, 16>();
}

// dt, x (B, S, D) of dtype; Bm, Cm (B, S, N), A (D, N), Dv (D,) float32;
// h0 (B, D, N) float32 or null (a zero state); y (B, S, D) of dtype and hT
// (B, D, N) float32.  Returns 0 or a CUDA error code (-1: arguments not
// supported).
extern "C" int mamba_scan_fwd_launch(int dtype, const void* dt, const void* x, const void* Bm, const void* Cm,
                                     const void* A, const void* Dv, const void* h0, void* y, void* hT, int B, int S,
                                     int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || !mamba_supported_state_dim(N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto bm = static_cast<const float*>(Bm);
  auto cm = static_cast<const float*>(Cm);
  auto a = static_cast<const float*>(A);
  auto dv = static_cast<const float*>(Dv);
  auto hin = static_cast<const float*>(h0);
  auto h = static_cast<float*>(hT);
  if (dtype == kFloat32) return dispatch<float>(N, dt, x, bm, cm, a, dv, hin, y, h, B, S, D, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(N, dt, x, bm, cm, a, dv, hin, y, h, B, S, D, s);
  return -1;
}
