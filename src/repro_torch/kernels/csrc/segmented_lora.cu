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
// ridge, so it is bound by reading W once from device memory (8.4 MB for
// q, 2.5 us at 3.35 TB/s).  The design keeps every SM reading W from its
// first cycle:
//  1. segmented_bottleneck_kernel computes t = T(mask(x @ A[idx])) once per
//     call, one block per row, with float32 FMAs, into a float32 scratch
//     (the rounded values).  It lets its dependent start at once.
//  2. segmented_stream_kernel is launched as its programmatic dependent.  A
//     block owns 128 bytes of each row of a K-slab of W (64 bf16 or 32
//     float32 columns); the slabs and column tiles make about two blocks
//     per SM at both decode shapes.  The block asks for its whole slab
//     (up to 64 KB) by 16-byte cp.async at its first instruction, in four
//     groups, and stages x's slab for the pass's rows in shared memory as
//     float32 meanwhile; it multiplies each group as it lands, with 32
//     interleaved rows of the slab per column unit, whose sums meet in a
//     fixed shuffle tree and then across the warps in order.  Its partial
//     sums go to a float32 scratch (splits, M, N).
//  3. The last block of a column tile to finish, chosen by an integer
//     ticket (no floating-point atomics), waits for t, sums the partials in
//     split order, adds t @ B[idx] over the slot's rank, and casts once; it
//     resets the ticket for the next call.
//
// Batch invariance: the slab and split count come from K, N and the SM
// count, never from M or idx, and a row's arithmetic (the order of every
// float32 sum) depends only on its own x, its own slot and the shapes, so
// a mixed-adapter batch gives bitwise the same rows as per-request adapter
// switching, and a row gives the same bits alone or in any batch.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 8;                    // 16-byte units of a block's slice of one row of W
constexpr int KLANES = THREADS / UNITS;     // interleaved rows of the slab, one thread each per unit
constexpr int MT = 8;                       // rows of x per pass
constexpr int STAGES = 4;                   // cp.async groups a slab arrives in
constexpr int SLAB_STEP = KLANES * STAGES;  // slab rows come in multiples of this
constexpr int MAX_SLAB = 512;               // 64 KB of W per block
constexpr int BLOCKS_PER_SM = 2;            // the grid aims at this many blocks per SM
constexpr int RT = 8;                       // rank tile of the bottleneck
constexpr int MAX_R = 64;                   // largest pooled rank
static_assert(STAGES == 4, "the stage waits below are written out for four groups");
static_assert(MT == 8, "x's staged rows are read as two float4");

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

// One 16-byte unit of staged W as floats: 8 bf16 or 4 float32.
__device__ __forceinline__ void unit_to_float(const __nv_bfloat16* p, float (&out)[8]) { load8(p, out); }
__device__ __forceinline__ void unit_to_float(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

struct Plan {
  int slab, splits, tiles;
};

// The K-slab and the column tiles of W: from K, N, the element size and the
// SM count alone.
Plan make_plan(int elt, int K, int N, int sms) {
  const int tn = UNITS * 16 / elt;
  Plan p;
  p.tiles = (N + tn - 1) / tn;
  const int want = std::max(1, (BLOCKS_PER_SM * sms + p.tiles - 1) / p.tiles);
  p.slab = std::min(MAX_SLAB, ((K + want - 1) / want + SLAB_STEP - 1) / SLAB_STEP * SLAB_STEP);
  p.splits = (K + p.slab - 1) / p.slab;
  return p;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

template <typename T>
size_t smem_bytes(int slab) {
  constexpr int TN = UNITS * 16 / sizeof(T);
  return (size_t)slab * UNITS * 16 + (size_t)slab * MT * sizeof(float) + (size_t)WARPS * MT * TN * sizeof(float);
}

// (1) t[m][r] = T(sum_k x[m,k] A[slot,k,r]) for r < the slot's rank, else 0;
// one block per row, thread j sums k = j, j + THREADS, ..., RT ranks at a
// time, then a fixed shuffle tree and the warps in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
segmented_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ a, const int* __restrict__ idx,
                            const int* __restrict__ ranks, float* __restrict__ t, int K, int R, int vec_a) {
  __shared__ float red[WARPS][RT];
  pdl_launch_dependents();  // the stream kernel reads no t until its last block
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = idx[m], rank = min(ranks[s], R);
  const T* xm = x + (size_t)m * K;
  const T* as = a + (size_t)s * K * R;
  for (int r0 = 0; r0 < R; r0 += RT) {
    float acc[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[j] = 0.f;
    if (r0 < rank) {
#pragma unroll 8
      for (int k = tid; k < K; k += THREADS) {
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
        for (int j = 0; j < RT; ++j) acc[j] = fmaf(xv, av[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const float v = warp_sum(acc[j]);
      if (lane == 0) red[warp][j] = v;
    }
    __syncthreads();
    if (tid < RT && r0 + tid < R) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][tid];
      const int r = r0 + tid;
      t[(size_t)m * R + r] = r < rank ? to_float(from_float<T>(v)) : 0.f;
    }
    __syncthreads();
  }
}

// (2) + (3): the block (column tile blockIdx.x, K-slab blockIdx.y).
template <typename T>
__global__ void __launch_bounds__(THREADS)
segmented_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                        const int* __restrict__ idx, const int* __restrict__ ranks, const float* __restrict__ t,
                        float* __restrict__ part, int* __restrict__ tickets, T* __restrict__ y, int M, int K, int N,
                        int R, int slab, int vec_w) {
  constexpr int CPT = 16 / sizeof(T);  // columns per unit
  constexpr int TN = UNITS * CPT;      // columns per tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);                               // [slab][TN]
  float* x_s = reinterpret_cast<float*>(smem + (size_t)slab * 16 * UNITS);  // [slab][MT]
  float* red = x_s + (size_t)slab * MT;                              // [WARPS][MT][TN]
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = tid % UNITS, kl = tid / UNITS;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = tile * TN, k0 = split * slab, kn = min(slab, K - k0);
  const int q = slab / STAGES;  // rows per group, a multiple of KLANES
  const int nu = n0 + unit * CPT;

  // the whole slab of W in flight at once, zero past K and N
#pragma unroll
  for (int g = 0; g < STAGES; ++g) {
    for (int kk = g * q + kl; kk < (g + 1) * q; kk += KLANES) {
      T* dst = w_s + (size_t)kk * TN + unit * CPT;
      const T* src = w + (size_t)(k0 + min(kk, kn - 1)) * N;
      if (vec_w) {
        const bool in = kk < kn && nu < N;
        cp_async16(dst, in ? src + nu : w, in ? 16 : 0);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) dst[c] = kk < kn && nu + c < N ? src[nu + c] : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  }

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    for (int e = tid; e < MT * slab; e += THREADS) {  // x's slab, coalesced along k, staged [k][row]
      const int i = e / slab, kk = e % slab;
      x_s[kk * MT + i] = i < mt && kk < kn ? to_float(x[(size_t)(m0 + i) * K + k0 + kk]) : 0.f;
    }
    float acc[MT][CPT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
#pragma unroll
    for (int g = 0; g < STAGES; ++g) {
      if (m0 == 0) {  // group g of W has landed
        if (g == 0) cp_async_wait<3>();
        else if (g == 1) cp_async_wait<2>();
        else if (g == 2) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      __syncthreads();  // every thread's copies of the group (and x's slab) are visible
      for (int kk = g * q + kl; kk < (g + 1) * q; kk += KLANES) {
        float wv[CPT];
        unit_to_float(w_s + (size_t)kk * TN + unit * CPT, wv);
        const float4 xa = *reinterpret_cast<const float4*>(x_s + kk * MT);
        const float4 xb = *reinterpret_cast<const float4*>(x_s + kk * MT + 4);
        const float xv[MT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
      }
    }
    // a unit's 32 row lanes: lanes l, l ^ 8, l ^ 16, l ^ 24 of each warp in a
    // fixed shuffle tree, then the warps in order
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float v = acc[i][c];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < UNITS) red[(warp * MT + i) * TN + lane * CPT + c] = v;
      }
    __syncthreads();
    for (int e = tid; e < MT * TN; e += THREADS) {
      const int i = e / TN, col = e % TN, n = n0 + col;
      if (i < mt && n < N) {
        float v = 0.f;
#pragma unroll
        for (int wp = 0; wp < WARPS; ++wp) v += red[(wp * MT + i) * TN + col];
        part[((size_t)split * M + m0 + i) * N + n] = v;
      }
    }
    __syncthreads();  // red and x's slab are free for the next pass
  }

  // the tile's last block to finish merges the splits
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  pdl_wait();  // t is written
  for (int e = tid; e < M * TN; e += THREADS) {
    const int m = e / TN, n = n0 + e % TN;
    if (n >= N) continue;
    float main = 0.f;
    for (int s = 0; s < splits; ++s) main += __ldcg(part + ((size_t)s * M + m) * N + n);
    const int slot = idx[m], rank = min(ranks[slot], R);
    const T* bs = b + (size_t)slot * R * N + n;
    const float* tm = t + (size_t)m * R;
    float side = 0.f;
    for (int r = 0; r < rank; ++r) side = fmaf(tm[r], to_float(bs[(size_t)r * N]), side);
    y[(size_t)m * N + n] = from_float<T>(main + side);
  }
  if (tid == 0) tickets[tile] = 0;  // ready for the next call on this stream
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b, const int* idx, const int* ranks, float* t,
           float* part, int* tickets, void* y, int M, int K, int N, int R, int splits, cudaStream_t stream) {
  const Plan p = make_plan(sizeof(T), K, N, sm_count());
  if (p.splits != splits) return -1;  // the caller sized part by its own plan (ops.segmented_lora_plan)
  const int vec_a = R % RT == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_w = N % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  segmented_bottleneck_kernel<T><<<M, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(a), idx,
                                                            ranks, t, K, R, vec_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes<T>(p.slab);
  err = cudaFuncSetAttribute(segmented_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(segmented_stream_kernel<T>, dim3(p.tiles, p.splits), dim3(THREADS), smem, stream,
                         static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), idx, ranks,
                         static_cast<const float*>(t), part, tickets, static_cast<T*>(y), M, K, N, R, p.slab, vec_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int elt_size(int dtype) { return dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 0; }

}  // namespace

// Dynamic shared memory of the stream kernel at (dtype, K, N), for reports.
extern "C" int segmented_lora_smem_bytes(int dtype, int K, int N) {
  if (!elt_size(dtype) || K <= 0 || N <= 0) return -1;
  const Plan p = make_plan(elt_size(dtype), K, N, sm_count());
  return static_cast<int>(dtype == kFloat32 ? smem_bytes<float>(p.slab) : smem_bytes<__nv_bfloat16>(p.slab));
}

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take.  Scratch from the caller: t (M, R)
// float32; part (splits, M, N) float32, splits = make_plan's (mirrored by
// ops.segmented_lora_plan, a launch with other splits is refused); tickets
// (make_plan's tiles or more,) int32, zero before the first call on a
// stream and left zero by each call.  Shapes, dtypes and devices are
// checked by the Python wrapper (repro_torch/kernels/ops.py) before this.
extern "C" int segmented_lora_launch(int dtype, const void* x, const void* w, const void* a, const void* b,
                                     const int* idx, const int* ranks, void* t, void* part, void* tickets, void* y,
                                     int M, int K, int N, int R, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || R <= 0 || R > MAX_R) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto tf = static_cast<float*>(t);
  auto pf = static_cast<float*>(part);
  auto tk = static_cast<int*>(tickets);
  if (dtype == kFloat32) return launch<float>(x, w, a, b, idx, ranks, tf, pf, tk, y, M, K, N, R, splits, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w, a, b, idx, ranks, tf, pf, tk, y, M, K, N, R, splits, s);
  return -1;
}
