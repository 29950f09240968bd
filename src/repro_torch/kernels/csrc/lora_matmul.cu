// Fused LoRA matmul for Hopper (sm_90a):
//
//   y = T( x @ W  +  alpha * (T(x @ A) @ B) )
//
// x (M, K) contiguous; W (K, N), A (K, r) and B (r, N) given by pointer and
// two strides each, so a transposed view needs no copy; y (M, N).
//
// Replaces src/repro/kernels/lora_matmul.py: lora_matmul_pallas (kernel
// body _lora_kernel), with its op order: the main product and the rank-r
// bottleneck t accumulate in float32, t is rounded to the input dtype T,
// t @ B accumulates in float32, and main + alpha * side is cast once.
//
// The backward of the port's autograd Function reuses this kernel for
//   dX = dY @ W^T + alpha * T(dY @ B^T) @ A^T
// by passing (dY, W^T, B^T, A^T) as strided views.  dA and dB are rank-r
// products that stay torch.matmul, as the JAX package leaves them to XLA.
//
// Design.  The TPU grid (M blocks, N blocks) keeps K whole in VMEM; here a
// block owns a tile of y and loops over K in chunks of 32, accumulating both
// x @ W and the bottleneck x @ A (A's columns padded with zeros to a multiple
// of 16) in float32; after the loop it rounds t, stages B's rows for its
// columns and adds alpha * t @ B.  Each block recomputes t for its rows:
// 2 M K r extra FLOPs per N tile, r / BN of the main product.
//  * bf16 (the training path), v2: tensor cores through WMMA (mma.sync), a
//    128 x 128 tile per block of 8 warps, each warp's 32 x 64 accumulators
//    in registers for the whole K loop, operands staged by 16-byte cp.async
//    into two shared-memory buffers so the next chunk loads while this one
//    multiplies.  A transposed view (dX) is staged as it lies in memory and
//    read as column-major fragments.
//  * float32: CUDA-core FMAs on 32 x 32 tiles with the accumulators in
//    shared memory (full float32; the tensor cores would round to TF32).
//
// What bounds it on the card: at the training shape of the q projection
// (M 8192, K 2048, N 2048, r 8, bf16) it does ~6.9e10 FLOPs over ~50 MB, so
// the tensor cores bound it (~70 us at 989 TFLOP/s).  Still simple: WMMA's
// mma.sync reaches a fraction of what wgmma with TMA would.
#include <cuda_pipeline_primitives.h>

#include <type_traits>

#include "tiles.cuh"

namespace {

constexpr int KC = 32;     // K chunk
constexpr int MAX_R = 64;  // largest rank (ops.MAX_LORA_RANK)
constexpr int MAX_RP = 64; // rank padded to 16

// ---------------------------------------------------------------- float32
// CUDA-core FMAs (full float32); the accumulators live in shared memory.
template <typename T>
struct LoraSmem {
  static constexpr int BM = Tile<T>::R, BN = Tile<T>::R;
  static constexpr int ldx = KC + PAD_T, ldw = BN + PAD_T, lda = MAX_RP + PAD_T, ldc = BN + PAD_F,
                       ldt = MAX_RP + PAD_F, ldtt = MAX_RP + PAD_T, ldb = BN + PAD_T;
  static constexpr size_t x = 0;
  static constexpr size_t w = x + align128(sizeof(T) * BM * ldx);
  static constexpr size_t a = w + align128(sizeof(T) * KC * ldw);
  static constexpr size_t c = a + align128(sizeof(T) * KC * lda);
  static constexpr size_t t = c + align128(sizeof(float) * BM * ldc);
  static constexpr size_t tt = t + align128(sizeof(float) * BM * ldt);
  static constexpr size_t b = tt + align128(sizeof(T) * BM * ldtt);
  static constexpr size_t side = b + align128(sizeof(T) * MAX_RP * ldb);
  static constexpr size_t bytes = side + align128(sizeof(float) * BM * ldc);
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
lora_matmul_fma_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                   const T* __restrict__ b, T* __restrict__ y, int M, int K, int N, int R, long long sw0,
                   long long sw1, long long sa0, long long sa1, long long sb0, long long sb1, float alpha) {
  using L = LoraSmem<T>;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* x_s = reinterpret_cast<T*>(smem + L::x);
  T* w_s = reinterpret_cast<T*>(smem + L::w);
  T* a_s = reinterpret_cast<T*>(smem + L::a);
  float* c_s = reinterpret_cast<float*>(smem + L::c);
  float* t_s = reinterpret_cast<float*>(smem + L::t);
  T* tt_s = reinterpret_cast<T*>(smem + L::tt);
  T* b_s = reinterpret_cast<T*>(smem + L::b);
  float* side_s = reinterpret_cast<float*>(smem + L::side);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int RP = (R + 15) / 16 * 16;
  const int mvalid = min(BM, M - m0), nvalid = min(BN, N - n0);

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kvalid = min(KC, K - k0);
    load_strided(x_s, L::ldx, x + (long long)m0 * K + k0, K, 1, BM, KC, mvalid, kvalid);
    load_strided(w_s, L::ldw, w + k0 * sw0 + n0 * sw1, sw0, sw1, KC, BN, kvalid, nvalid);
    load_strided(a_s, L::lda, a + k0 * sa0, sa0, sa1, KC, RP, kvalid, R);
    __syncthreads();
    tile_mma<false>(c_s, L::ldc, x_s, L::ldx, w_s, L::ldw, BM, BN, KC, k0 > 0);  // main += x W
    tile_mma<false>(t_s, L::ldt, x_s, L::ldx, a_s, L::lda, BM, RP, KC, k0 > 0);  // t += x A
    __syncthreads();
  }
  for (int e = threadIdx.x; e < BM * RP; e += blockDim.x) {
    const int i = e / RP, r = e % RP;
    tt_s[i * L::ldtt + r] = from_float<T>(t_s[i * L::ldt + r]);  // t rounded to T
  }
  load_strided(b_s, L::ldb, b + n0 * sb1, sb0, sb1, RP, BN, R, nvalid);
  __syncthreads();
  tile_mma<false>(side_s, L::ldc, tt_s, L::ldtt, b_s, L::ldb, BM, BN, RP, false);  // side = t B
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int i = e / BN, j = e % BN;
    if (i < mvalid && j < nvalid) {
      y[(long long)(m0 + i) * N + n0 + j] = from_float<T>(c_s[i * L::ldc + j] + alpha * side_s[i * L::ldc + j]);
    }
  }
}

int launch_fma(const void* x, const void* w, const void* a, const void* b, void* y, int M, int K, int N, int R,
               long long sw0, long long sw1, long long sa0, long long sa1, long long sb0, long long sb1,
               float alpha, cudaStream_t stream) {
  using T = float;
  using L = LoraSmem<T>;
  cudaError_t err = cudaFuncSetAttribute(lora_matmul_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM);
  lora_matmul_fma_kernel<T><<<grid, TILE_THREADS, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(y), M, K, N, R, sw0, sw1, sa0, sa1, sb0, sb1, alpha);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bfloat16
// Tensor cores.  A 128 x 128 tile of y per block, 8 warps in a 4 x 2 grid,
// each warp 32 x 64 of y in 2 x 4 accumulator fragments held in registers
// across K, and one 16-row strip of t (up to 4 fragments).  Operands are
// staged by 16-byte cp.async copies into two buffers, so chunk c + 1 loads
// while chunk c multiplies.  COL = false: W, A and B row-major (the
// forward).  COL = true: W, A and B are transposed views of row-major
// tensors (dX); each is staged as it lies in memory and read as
// column-major fragments, so no copy of W is made.
using bf16 = __nv_bfloat16;
constexpr int WM = 128, WN = 128, WK = 32, WTHREADS = 256;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

struct WmmaSmem {
  static constexpr int ldx = WK + PAD_T;
  static constexpr int ldt = MAX_RP + PAD_F;
  static constexpr int ldc = WN + PAD_F;
  static constexpr int ldtt = MAX_RP + PAD_T;
  static constexpr size_t x_bytes = align128(sizeof(bf16) * WM * ldx);
  static constexpr size_t w_bytes = align128(sizeof(bf16) * cmax(WK * (WN + PAD_T), WN * (WK + PAD_T)));
  static constexpr size_t a_bytes = align128(sizeof(bf16) * cmax(WK * (MAX_RP + PAD_T), MAX_RP * (WK + PAD_T)));
  static constexpr size_t buf = x_bytes + w_bytes + a_bytes;
  static constexpr size_t t = 2 * buf;  // t after the loop; y's float tile then reuses [0, region)
  static constexpr size_t region = cmax(t + align128(sizeof(float) * WM * ldt), align128(sizeof(float) * WM * ldc));
  static constexpr size_t tt = region;
  static constexpr size_t b = tt + align128(sizeof(bf16) * WM * ldtt);
  static constexpr size_t bytes = b + align128(sizeof(bf16) * cmax(MAX_RP * (WN + PAD_T), WN * (MAX_RP + PAD_T)));
};

// Stage a (rows x cols) tile whose rows lie contiguously in memory: element
// (i, j) at src[i * ld + j], zero outside (vrows, vcols).  Whole 16-byte
// groups go by cp.async when `vec` (src 16-byte aligned, ld a multiple of
// 8); the ragged rest element by element.  cols is a multiple of 8.
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src, long long ld, int rows, int cols,
                                      int vrows, int vcols, int vec) {
  const int vpr = cols / 8;
  for (int e = threadIdx.x; e < rows * vpr; e += blockDim.x) {
    const int i = e / vpr, j = (e % vpr) * 8;
    bf16* d = dst + i * ldd + j;
    if (vec && i < vrows && j + 8 <= vcols) {
      __pipeline_memcpy_async(d, src + i * ld + j, 16);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = (i < vrows && j + u < vcols) ? src[i * ld + j + u] : __float2bfloat16(0.f);
    }
  }
}

template <bool COL>
__global__ void __launch_bounds__(WTHREADS)
lora_matmul_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ a,
                        const bf16* __restrict__ b, bf16* __restrict__ y, int M, int K, int N, int R, long long ldw,
                        long long lda, long long ldb, int vec_x, int vec_w, int vec_a, int vec_b, int vec_y,
                        float alpha) {
  using namespace nvcuda;
  using L = WmmaSmem;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<COL, wmma::col_major, wmma::row_major>::type>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int ldws = COL ? WK + PAD_T : WN + PAD_T;      // staged W: [n][k] or [k][n]
  constexpr int ldas = COL ? WK + PAD_T : MAX_RP + PAD_T;  // staged A: [r][k] or [k][r]
  constexpr int ldbs = COL ? MAX_RP + PAD_T : WN + PAD_T;  // staged B: [n][r] or [r][n]
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  const int RP = (R + 15) / 16 * 16;
  const int mvalid = min(WM, M - m0), nvalid = min(WN, N - n0);

  // B fragment (k0, n0) of a staged operand: row-major [k][n] or column-major [n][k]
  auto load_b = [](FragB& f, const bf16* base, int ld, int k0, int n0) {
    if constexpr (COL) {
      wmma::load_matrix_sync(f, base + n0 * ld + k0, ld);
    } else {
      wmma::load_matrix_sync(f, base + k0 * ld + n0, ld);
    }
  };
  auto stage_chunk = [&](int k0, int buf) {
    unsigned char* base = smem + buf * L::buf;
    bf16* xs = reinterpret_cast<bf16*>(base);
    bf16* ws = reinterpret_cast<bf16*>(base + L::x_bytes);
    bf16* as = reinterpret_cast<bf16*>(base + L::x_bytes + L::w_bytes);
    stage(xs, L::ldx, x + (long long)m0 * K + k0, K, WM, WK, mvalid, K - k0, vec_x);
    if constexpr (COL) {
      stage(ws, ldws, w + (long long)n0 * ldw + k0, ldw, WN, WK, nvalid, K - k0, vec_w);
      stage(as, ldas, a + k0, lda, RP, WK, R, K - k0, vec_a);
    } else {
      stage(ws, ldws, w + (long long)k0 * ldw + n0, ldw, WK, WN, K - k0, nvalid, vec_w);
      stage(as, ldas, a + (long long)k0 * lda, lda, WK, RP, K - k0, R, vec_a);
    }
  };

  FragC acc[2][4], tacc[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(tacc[j], 0.f);

  const int nk = (K + WK - 1) / WK;
  stage_chunk(0, 0);
  __pipeline_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) stage_chunk((c + 1) * WK, (c + 1) & 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // chunk c has landed; chunk c + 1 may be in flight
    __syncthreads();
    const unsigned char* base = smem + (c & 1) * L::buf;
    const bf16* xs = reinterpret_cast<const bf16*>(base);
    const bf16* ws = reinterpret_cast<const bf16*>(base + L::x_bytes);
    const bf16* as = reinterpret_cast<const bf16*>(base + L::x_bytes + L::w_bytes);
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      FragA af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], xs + (wr * 32 + i * 16) * L::ldx + kk, L::ldx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bfr;
        load_b(bfr, ws, ldws, kk, wc * 64 + j * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
      FragA at;  // t: this warp's 16-row strip
      wmma::load_matrix_sync(at, xs + (warp * 16) * L::ldx + kk, L::ldx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 16 < RP) {
          FragB bfr;
          load_b(bfr, as, ldas, kk, j * 16);
          wmma::mma_sync(tacc[j], at, bfr, tacc[j]);
        }
      }
    }
    __syncthreads();
  }

  // t -> float tile -> rounded to bf16; B's rows for this block's columns
  float* ts = reinterpret_cast<float*>(smem + L::t);
  bf16* tts = reinterpret_cast<bf16*>(smem + L::tt);
  bf16* bs = reinterpret_cast<bf16*>(smem + L::b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j * 16 < RP) wmma::store_matrix_sync(ts + warp * 16 * L::ldt + j * 16, tacc[j], L::ldt, wmma::mem_row_major);
  }
  if constexpr (COL) {
    stage(bs, ldbs, b + (long long)n0 * ldb, ldb, WN, RP, nvalid, R, vec_b);
  } else {
    stage(bs, ldbs, b + n0, ldb, RP, WN, R, nvalid, vec_b);
  }
  __pipeline_commit();
  __syncthreads();
  for (int e = threadIdx.x; e < WM * RP; e += blockDim.x) {
    const int i = e / RP, r = e % RP;
    tts[i * L::ldtt + r] = __float2bfloat16(ts[i * L::ldt + r]);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // y = main + alpha * (t @ B), combined in the fragments, then staged as float
  float* cs = reinterpret_cast<float*>(smem);  // reuses the operand buffers and t
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragC side;
      wmma::fill_fragment(side, 0.f);
      for (int kk = 0; kk < RP; kk += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(af, tts + (wr * 32 + i * 16) * L::ldtt + kk, L::ldtt);
        load_b(bfr, bs, ldbs, kk, wc * 64 + j * 16);
        wmma::mma_sync(side, af, bfr, side);
      }
#pragma unroll
      for (int e = 0; e < side.num_elements; ++e) acc[i][j].x[e] = acc[i][j].x[e] + alpha * side.x[e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * L::ldc + wc * 64 + j * 16, acc[i][j], L::ldc,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < WM * (WN / 8); e += blockDim.x) {
    const int i = e / (WN / 8), j = (e % (WN / 8)) * 8;
    if (i >= mvalid) continue;
    const float* src = cs + i * L::ldc + j;
    bf16* dst = y + (long long)(m0 + i) * N + n0 + j;
    if (vec_y && j + 8 <= nvalid) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __float2bfloat16(src[u]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int u = 0; u < 8 && j + u < nvalid; ++u) dst[u] = __float2bfloat16(src[u]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_wmma(const void* x, const void* w, const void* a, const void* b, void* y, int M, int K, int N, int R,
                long long sw0, long long sw1, long long sa0, long long sa1, long long sb0, long long sb1, float alpha,
                cudaStream_t stream) {
  const bool row = sw1 == 1 && sa1 == 1 && sb1 == 1;
  const bool col = sw0 == 1 && sa0 == 1 && sb0 == 1;
  if (!row && !col) return -1;  // W, A, B all row-major (forward) or all transposed views (dX)
  const long long ldw = row ? sw0 : sw1, lda = row ? sa0 : sa1, ldb = row ? sb0 : sb1;
  const int vec_x = aligned16(x) && K % 8 == 0, vec_y = aligned16(y) && N % 8 == 0;
  const int vec_w = aligned16(w) && ldw % 8 == 0, vec_a = aligned16(a) && lda % 8 == 0;
  const int vec_b = aligned16(b) && ldb % 8 == 0;
  const dim3 grid((N + WN - 1) / WN, (M + WM - 1) / WM);
  auto kernel = row ? lora_matmul_wmma_kernel<false> : lora_matmul_wmma_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(WmmaSmem::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, WTHREADS, WmmaSmem::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(a),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), M, K, N, R, ldw, lda, ldb, vec_x, vec_w, vec_a, vec_b,
      vec_y, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, the cudaError_t of a refused launch, or -1 for
// arguments the kernel does not take.  Shapes, dtypes, devices and x's
// contiguity are checked by the Python wrapper (repro_torch/kernels/ops.py).
extern "C" int lora_matmul_launch(int dtype, const void* x, const void* w, const void* a, const void* b, void* y,
                                  int M, int K, int N, int R, long long sw0, long long sw1, long long sa0,
                                  long long sa1, long long sb0, long long sb1, float alpha, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || R <= 0 || R > MAX_R) return -1;
  if ((M + 31) / 32 > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_fma(x, w, a, b, y, M, K, N, R, sw0, sw1, sa0, sa1, sb0, sb1, alpha, s);
  if (dtype == kBFloat16) return launch_wmma(x, w, a, b, y, M, K, N, R, sw0, sw1, sa0, sa1, sb0, sb1, alpha, s);
  return -1;
}
