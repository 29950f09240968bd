// Segmented multi-adapter LoRA matmul for Hopper (sm_90a):
//
//   y[i] = T( x[i] @ W  +  T(mask_{r < ranks[idx[i]]}(x[i] @ A[idx[i]])) @ B[idx[i]] )
//
// Replaces src/repro/kernels/segmented_lora.py: segmented_lora_pallas
// (kernel body _segmented_kernel).  Same op order as the TPU kernel: the
// main product and the rank bottleneck t accumulate in float32; t's tail
// beyond the slot's true rank is zeroed (a recycled slot may hold a stale
// tail of a higher-rank adapter); t is rounded to the input dtype T; the
// t @ B dot accumulates in float32; main + side is cast to T once.  The
// alpha/rank scale is already folded into B by the adapter pool.
//
// What bounds it: at decode batch M = 8 the product is 8 x 2048 x {2048,
// 1024}, about 8 FLOP per byte of W, far below the card's ~295 FLOP/byte
// ridge, so it is bound by reading W once from device memory.  The TPU grid
// is (M rows, N blocks) and reads W once per row; here a block owns TN = 16
// columns of the output for ALL rows, so W is read from memory once per
// call, and 2048 / 16 = 128 blocks cover the card's 132 SMs.  A block's 256
// threads split K into 128 interleaved slices; each thread loads 8 columns
// of W (16 bytes of bf16) per row of K, several rows in flight, so that
// enough bytes are outstanding to cover the memory latency.  The partial
// sums of the slices meet through warp shuffles and shared memory in a
// fixed order.  The small bottleneck t (M x r_max) is computed by every
// block again, one warp per row, with 16-byte loads of A.
//
// Batch invariance: a row's arithmetic (the order of every float32 sum)
// depends only on its own x, its own slot and the shapes, never on the
// other rows' adapters or on its position in the batch, so a mixed-adapter
// batch gives bitwise the same rows as per-request adapter switching.
//
// Simple first: CUDA-core FMAs, no tensor cores, no TMA, no split of K
// across blocks.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 8;                    // columns per thread: one 16-byte load of bf16
constexpr int GROUPS = 2;                 // column groups per block
constexpr int TN = CPT * GROUPS;          // output columns per block
constexpr int SLICES = THREADS / GROUPS;  // interleaved slices of K
constexpr int MT = 8;                     // rows per pass
constexpr int RT = 8;                     // rank tile of the bottleneck
constexpr int MAX_R = 64;                 // largest pooled rank
static_assert(GROUPS == 2, "the slice reduction below skips lane bit 0 (the group)");
static_assert(MT * TN <= THREADS, "one finishing thread per output");
static_assert(MT == WARPS, "one warp per row for the bottleneck");
static_assert(RT == CPT, "load8 reads one rank tile");

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segmented_lora_kernel(const T* __restrict__ x,       // (M, K)
                      const T* __restrict__ w,       // (K, N)
                      const T* __restrict__ a,       // (NA, K, R)
                      const T* __restrict__ b,       // (NA, R, N)
                      const int* __restrict__ idx,   // (M,) slot per row
                      const int* __restrict__ ranks, // (NA,) true rank per slot
                      T* __restrict__ y,             // (M, N)
                      int M, int K, int N, int R, int vec, int vec_a) {
  __shared__ float part[WARPS][GROUPS][MT][CPT];   // main-product partials per warp
  __shared__ float t_s[MT][MAX_R];                 // rounded, masked bottleneck per row
  __shared__ int slot_s[MT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid % GROUPS;
  const int slice = tid / GROUPS;
  const int n0 = blockIdx.x * TN + g * CPT;  // this thread's first column
  const bool full = vec && n0 + CPT <= N;    // 16-byte aligned, all 8 columns in range

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    if (tid < mt) slot_s[tid] = idx[m0 + tid];
    __syncthreads();

    // (1) t[m][r] = sum_k x[m,k] A[slot,k,r] over the full pooled rank:
    //     warp i takes row i, its lanes split K, and each lane reads RT
    //     ranks of A at once; the lanes meet in a fixed shuffle tree.
    if (warp < mt) {
      const int i = warp;
      const int s = slot_s[i];
      const T* xm = x + (size_t)(m0 + i) * K;
      const T* as = a + (size_t)s * K * R;
      const int rank = ranks[s];
      for (int r0 = 0; r0 < R; r0 += RT) {
        float tacc[RT];
#pragma unroll
        for (int j = 0; j < RT; ++j) tacc[j] = 0.f;
#pragma unroll 4
        for (int k = lane; k < K; k += 32) {
          const float xv = to_float(xm[k]);
          const T* ar = as + (size_t)k * R + r0;
          float av[RT];
          if (vec_a) {
            load8(ar, av);
          } else {
#pragma unroll
            for (int j = 0; j < RT; ++j) av[j] = r0 + j < R ? to_float(ar[j]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < RT; ++j) tacc[j] += xv * av[j];
        }
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const float v = warp_sum(tacc[j]);
          const int r = r0 + j;
          if (lane == 0 && r < R) t_s[i][r] = r < rank ? to_float(from_float<T>(v)) : 0.f;
        }
      }
    }
    __syncthreads();

    // (2) main product: thread (slice, g) sums rows k = slice, slice + SLICES, ...
    //     of its 8 columns of W for every row of the pass.
    float acc[MT][CPT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int k = slice; k < K; k += SLICES) {
      float wv[CPT];
      const T* wp = w + (size_t)k * N + n0;
      if (full) {
        load8(wp, wv);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) wv[c] = n0 + c < N ? to_float(wp[c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          const float xv = to_float(x[(size_t)(m0 + i) * K + k]);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += xv * wv[c];
        }
      }
    }
    // slices of one warp: the lanes with the same group bit, a fixed shuffle tree
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float v = acc[i][c];
#pragma unroll
        for (int off = GROUPS; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < GROUPS) part[warp][lane][i][c] = v;
      }
    __syncthreads();

    // (3) one thread per output: the warps' partials in a fixed order, the
    //     side dot over the full pooled rank, one cast of main + side.
    if (tid < MT * TN) {
      const int i = tid / TN;
      const int col = tid % TN;
      const int n = blockIdx.x * TN + col;
      if (i < mt && n < N) {
        float main = 0.f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) main += part[v][col / CPT][i][col % CPT];
        const T* bs = b + (size_t)slot_s[i] * R * N + n;
        float side = 0.f;
        for (int r = 0; r < R; ++r) side += t_s[i][r] * to_float(bs[(size_t)r * N]);
        y[(size_t)(m0 + i) * N + n] = from_float<T>(main + side);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b, const int* idx,
           const int* ranks, void* y, int M, int K, int N, int R, cudaStream_t stream) {
  const int vec = N % CPT == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_a = R % RT == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  segmented_lora_kernel<T><<<(N + TN - 1) / TN, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(a),
      static_cast<const T*>(b), idx, ranks, static_cast<T*>(y), M, K, N, R, vec, vec_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take.  Shapes, dtypes and devices are
// checked by the Python wrapper (repro_torch/kernels/ops.py) before this.
extern "C" int segmented_lora_launch(int dtype, const void* x, const void* w, const void* a,
                                     const void* b, const int* idx, const int* ranks, void* y,
                                     int M, int K, int N, int R, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || R <= 0 || R > MAX_R) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, w, a, b, idx, ranks, y, M, K, N, R, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, w, a, b, idx, ranks, y, M, K, N, R, s);
  return -1;
}
