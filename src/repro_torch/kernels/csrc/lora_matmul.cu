// Fused LoRA matmul for Hopper (sm_90a):
//
//   y = T( x @ W  +  alpha * (T(x @ A) @ B) )
//
// x (M, K) contiguous; W (K, N), A (K, r) and B (r, N) given by pointer and
// two strides each, so a transposed view needs no copy; y (M, N).
//
// Grouped: with G groups of rows = M / G rows each, A and B carry a group
// axis (A_g at a + g * sag, B_g at b + g * sbg), and row i of group
// g = i / rows takes A_g and B_g; W stays shared.  One launch then runs a
// LoRA projection for a whole cohort of devices, each with its own
// adapter.  G = 1 (group strides unused) is the ungrouped call.  Every sum
// keeps the order it has in the ungrouped call on the group's rows alone,
// so group g's rows equal, bit for bit, that call with A_g and B_g.
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
// Three routes; the wrapper (repro_torch/kernels/ops.py) picks one by dtype
// and shape, and the launcher refuses a route that cannot take the
// arguments:
//  * wgmma (bf16, K and N multiples of 8, W row-major or a transposed view
//    of a row-major matrix): every training shape of the port.  Two
//    kernels.  The bottleneck kernel computes t = T(x @ A) once per row
//    with float32 FMAs on the CUDA cores, in a fixed order (each lane of a
//    warp sums its 8-element slices of K in order, then a butterfly across
//    the lanes), into an (M, RT) scratch; the tensor cores would truncate
//    each partial sum, and one flipped rounding of t at |t| >= 2 moves a
//    whole row of y by alpha * ulp(t) * B.  The main kernel is launched as
//    its programmatic dependent and waits for t only before its epilogue.  The main kernel runs x @ W on
//    the tensor cores: a 128 x 256 tile of y per block, two warpgroups of
//    64 rows, each holding its 64 x 256 float32 accumulator in registers
//    for the whole K loop (wgmma m64n256k16 from shared memory); thread 0
//    keeps a 4-slot ring of 64-deep chunks of x and W in flight by TMA
//    (mbarriers; W read MN-major in the forward, K-major as the dX's
//    transposed view).  The epilogue adds alpha * t @ B with FMAs in
//    registers (B's rows for the tile staged in shared memory; above rank
//    8, alpha times each group of 8 ranks' sum in turn), writes the
//    rounded tile to shared memory and stores it by TMA, which clips the
//    ragged edges.  Tiles are walked in groups of 16 row tiles so that
//    concurrent blocks share their W columns in L2.  No split-K and no
//    atomics: every sum has one order, set by the shapes.
//  * wmma (bf16, the other shapes: K or N not a multiple of 8): the same
//    bottleneck kernel (loading x element by element where its rows are
//    not 16-byte vectors), then the first design's main kernel, WMMA
//    mma.sync on cp.async double buffers, which reads t in its epilogue.
//  * float32: CUDA-core FMAs on 32 x 32 tiles with the accumulators in
//    shared memory (full float32; the tensor cores would round to TF32).
//
// Groups on each route: the float32 and WMMA kernels and the bottleneck
// kernel tile each group's rows apart (a block never spans two groups, so
// it stages one A_g or B_g).  The wgmma kernel tiles all M rows as one
// matrix (x @ W is the same for every group); its epilogue stages the B_g of
// every group its 128 rows touch and adds each row its own group's t @ B_g.
// The launcher refuses the wgmma route when those B_g would not fit beside
// the ring (span * RT > MAX_R, span = the groups one tile can touch: 1 when
// rows is a multiple of 128), and the wrapper then takes the WMMA route.
//
// What bounds it on the card: at the training shape of the q projection
// (M 8192, K 2048, N 2048, r 8, bf16) it does ~6.9e10 FLOPs over ~50 MB, so
// the tensor cores bound it (~70 us at 989 TFLOP/s); the bottleneck kernel
// reads x once more (~10 us at 3.35 TB/s).
#include <cuda_pipeline_primitives.h>

#include <type_traits>

#include "hopper.cuh"
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
                   const T* __restrict__ b, T* __restrict__ y, int rows, int K, int N, int R, long long sw0,
                   long long sw1, long long sa0, long long sa1, long long sag, long long sb0, long long sb1,
                   long long sbg, float alpha) {
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

  // this block's rows: tile i0 / BM of group g
  const int tpg = (rows + BM - 1) / BM, g = blockIdx.y / tpg, i0 = (blockIdx.y % tpg) * BM;
  const int m0 = g * rows + i0, n0 = blockIdx.x * BN;
  const int RP = (R + 15) / 16 * 16;
  const int mvalid = min(BM, rows - i0), nvalid = min(BN, N - n0);
  a += g * sag;
  b += g * sbg;

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

int launch_fma(const void* x, const void* w, const void* a, const void* b, void* y, int G, int rows, int K, int N,
               int R, long long sw0, long long sw1, long long sa0, long long sa1, long long sag, long long sb0,
               long long sb1, long long sbg, float alpha, cudaStream_t stream) {
  using T = float;
  using L = LoraSmem<T>;
  cudaError_t err = cudaFuncSetAttribute(lora_matmul_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + L::BN - 1) / L::BN, G * ((rows + L::BM - 1) / L::BM));
  lora_matmul_fma_kernel<T><<<grid, TILE_THREADS, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(y), rows, K, N, R, sw0, sw1, sa0, sa1, sag, sb0, sb1, sbg, alpha);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bfloat16
// Tensor cores.  A 128 x 128 tile of y per block, 8 warps in a 4 x 2 grid,
// each warp 32 x 64 of y in 2 x 4 accumulator fragments held in registers
// across K.  Operands are staged by 16-byte cp.async copies into two
// buffers, so chunk c + 1 loads while chunk c multiplies.  The bottleneck t
// comes from the bottleneck kernel below (float32 FMAs, rounded once), read
// in the epilogue.  COL = false: W and B row-major (the forward).  COL =
// true: W and B are transposed views of row-major tensors (dX); each is
// staged as it lies in memory and read as column-major fragments, so no
// copy of W is made.
using bf16 = __nv_bfloat16;
constexpr int WM = 128, WN = 128, WK = 32, WTHREADS = 256;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

struct WmmaSmem {
  static constexpr int ldx = WK + PAD_T;
  static constexpr int ldc = WN + PAD_F;
  static constexpr int ldtt = MAX_RP + PAD_T;
  static constexpr size_t x_bytes = align128(sizeof(bf16) * WM * ldx);
  static constexpr size_t w_bytes = align128(sizeof(bf16) * cmax(WK * (WN + PAD_T), WN * (WK + PAD_T)));
  static constexpr size_t buf = x_bytes + w_bytes;
  // y's float tile reuses the operand buffers after the loop
  static constexpr size_t region = cmax(2 * buf, align128(sizeof(float) * WM * ldc));
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
lora_matmul_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ t,
                        const bf16* __restrict__ b, bf16* __restrict__ y, int rows, int K, int N, int R, int RT,
                        long long ldw, long long ldb, long long sbg, int vec_x, int vec_w, int vec_b, int vec_y,
                        float alpha) {
  using namespace nvcuda;
  using L = WmmaSmem;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                               typename std::conditional<COL, wmma::col_major, wmma::row_major>::type>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int ldws = COL ? WK + PAD_T : WN + PAD_T;      // staged W: [n][k] or [k][n]
  constexpr int ldbs = COL ? MAX_RP + PAD_T : WN + PAD_T;  // staged B: [n][r] or [r][n]
  extern __shared__ __align__(128) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  // this block's rows: tile i0 / WM of group g, which takes B_g
  const int tpg = (rows + WM - 1) / WM, g = blockIdx.y / tpg, i0 = (blockIdx.y % tpg) * WM;
  const int m0 = g * rows + i0, n0 = blockIdx.x * WN;
  const int RP = (R + 15) / 16 * 16;
  const int mvalid = min(WM, rows - i0), nvalid = min(WN, N - n0);
  b += g * sbg;

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
    stage(xs, L::ldx, x + (long long)m0 * K + k0, K, WM, WK, mvalid, K - k0, vec_x);
    if constexpr (COL) {
      stage(ws, ldws, w + (long long)n0 * ldw + k0, ldw, WN, WK, nvalid, K - k0, vec_w);
    } else {
      stage(ws, ldws, w + (long long)k0 * ldw + n0, ldw, WK, WN, K - k0, nvalid, vec_w);
    }
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

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
    }
    __syncthreads();
  }

  // the tile's rows of t (zero past M and RT) and B's rows for its columns
  bf16* tts = reinterpret_cast<bf16*>(smem + L::tt);
  bf16* bs = reinterpret_cast<bf16*>(smem + L::b);
  if constexpr (COL) {
    stage(bs, ldbs, b + (long long)n0 * ldb, ldb, WN, RP, nvalid, R, vec_b);
  } else {
    stage(bs, ldbs, b + n0, ldb, RP, WN, R, nvalid, vec_b);
  }
  __pipeline_commit();
  pdl_wait();  // t is written
  for (int e = threadIdx.x; e < WM * RP; e += blockDim.x) {
    const int i = e / RP, r = e % RP;
    tts[i * L::ldtt + r] = i < mvalid && r < RT ? t[(long long)(m0 + i) * RT + r] : __float2bfloat16(0.f);
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // y = main + alpha * (t @ B), combined in the fragments, then staged as float
  float* cs = reinterpret_cast<float*>(smem);  // reuses the operand buffers
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


// ---------------------------------------------------------- bf16, Hopper
// (1) The bottleneck t = T(x @ A) in float32 FMAs, for both bf16 routes.  A
// block of 8 warps owns 32 rows (4 a warp) and 8 columns of t.  Lane l
// takes the 8-element slices v = l, l + 32, ... of K in order and
// accumulates 4 rows x 8 columns.  Each thread prefetches its own slices of
// x (its 4 rows) by 16-byte cp.async into a ring of BT_XD slots in shared
// memory, so several iterations' loads stay in flight while it computes
// (XV false: x's rows are not 16-byte vectors, K off 8 or x unaligned, and
// each slice is loaded element by element, zero past K); A's 8 columns are
// staged in passes of BT_KC rows, two buffers, the next pass loading while
// this one computes.  One cp.async group per iteration carries the slices
// it prefetches and, at a pass's start, the next pass of A.  Staged layouts
// of A: a row-major A keeps one 16-byte unit (8 columns) per k, the units
// of slice v rotated by v so that the 8 lanes of a quarter warp reading
// unit e of their slices hit 8 distinct 16-byte bank groups; a transposed
// view (K a multiple of 8) keeps each column's BT_KC values contiguous;
// other strides or a partial column group load element by element.  The
// rows of A past K, up to the last slice's end, are staged as zeros.
constexpr int BT_THREADS = 256, BT_WARPS = 8, BT_ROWS = 4, BT_KC = 1024, BT_XD = 4;
constexpr int BT_IPP = BT_KC / 8 / 32;  // a lane's iterations per pass
static_assert(BT_XD - 1 <= BT_IPP, "a pass of A lands before the pass that reads it");
constexpr int BT_SMEM = 2 * BT_KC * 8 * 2 + BT_XD * BT_WARPS * BT_ROWS * 32 * 16;
enum BtLayout { kBtScalar = 0, kBtRows = 1, kBtCols = 2 };

__device__ __forceinline__ int bt_unit(int k) { return (k & ~7) | ((k + (k >> 3)) & 7); }

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int LAYOUT, bool XV>
__global__ void __launch_bounds__(BT_THREADS, 2)
lora_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a, bf16* __restrict__ t, int M, int K,
                       int R, int RT, long long sa0, long long sa1, long long sag) {
  extern __shared__ __align__(16) unsigned char bt_smem[];
  bf16* a_s = reinterpret_cast<bf16*>(bt_smem);                      // [2][BT_KC * 8]
  uint4* x_s = reinterpret_cast<uint4*>(bt_smem + 2 * BT_KC * 8 * 2);  // [BT_XD][BT_WARPS][BT_ROWS][32]
  pdl_launch_dependents();  // the main kernel's blocks may take the SMs this grid frees
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * 8;
  // M is the rows of one group here; the block's group g takes A_g
  const int bpg = (M + BT_WARPS * BT_ROWS - 1) / (BT_WARPS * BT_ROWS), g = blockIdx.x / bpg;
  x += (long long)g * M * K;
  t += (long long)g * M * RT;
  a += g * sag;
  const int row0 = (blockIdx.x % bpg) * (BT_WARPS * BT_ROWS) + warp * BT_ROWS;
  const int nvec = (K + 7) / 8, n_i = (nvec + 31) / 32, np = (K + BT_KC - 1) / BT_KC;
  float acc[BT_ROWS][8];
#pragma unroll
  for (int r = 0; r < BT_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  auto x_slot = [&](int i, int r) { return x_s + (((i % BT_XD) * BT_WARPS + warp) * BT_ROWS + r) * 32 + lane; };
  auto issue_x = [&](int i) {  // this thread's slice of iteration i, its 4 rows (zero past M and K)
    const int v = lane + 32 * i;
#pragma unroll
    for (int r = 0; r < BT_ROWS; ++r) {
      const bool in = v < nvec && row0 + r < M;
      if constexpr (XV) {
        cp_async16(x_slot(i, r), in ? x + (long long)(row0 + r) * K + 8 * v : x, in ? 16 : 0);
      } else {  // the thread's own slot, read back by this thread alone
        __align__(16) bf16 xv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xv[e] = in && 8 * v + e < K ? x[(long long)(row0 + r) * K + 8 * v + e] : __float2bfloat16(0.f);
        *x_slot(i, r) = *reinterpret_cast<const uint4*>(xv);
      }
    }
  };
  auto stage = [&](int p) {  // pass p of A into a_s[p & 1]
    const int k0 = p * BT_KC, kc = min(BT_KC, K - k0), kc8 = (kc + 7) / 8 * 8;
    bf16* dst = a_s + (p & 1) * BT_KC * 8;
    if constexpr (LAYOUT == kBtRows) {
      for (int k = threadIdx.x; k < kc8; k += BT_THREADS)
        cp_async16(dst + bt_unit(k) * 8, a + (long long)(k0 + min(k, kc - 1)) * sa0 + c0, k < kc ? 16 : 0);
    } else if constexpr (LAYOUT == kBtCols) {
      for (int e = threadIdx.x; e < kc; e += BT_THREADS) {  // kc / 8 vectors of each of 8 columns
        const int c = e / (kc / 8), q = e % (kc / 8);
        cp_async16(dst + c * BT_KC + 8 * q, a + (long long)(c0 + c) * sa1 + k0 + 8 * q, 16);
      }
    } else {
      for (int e = threadIdx.x; e < kc8 * 8; e += BT_THREADS) {
        int k, c;
        if (sa1 == 1) {  // neighbouring threads along A's rows
          k = e >> 3;
          c = e & 7;
        } else {  // along its columns
          c = e / kc8;
          k = e % kc8;
        }
        dst[bt_unit(k) * 8 + c] = k < kc && c0 + c < R ? a[(long long)(k0 + k) * sa0 + (long long)(c0 + c) * sa1]
                                                       : __float2bfloat16(0.f);
      }
    }
  };
  // groups 0 .. BT_XD - 2: iterations 0 .. BT_XD - 2 (and pass 0 of A)
  stage(0);
  for (int i = 0; i < BT_XD - 1; ++i) {
    if (i < n_i) issue_x(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_i; ++i) {
    cp_async_wait<BT_XD - 2>();  // groups 0 .. i have landed
    const int p = i / BT_IPP;
    if (i % BT_IPP == 0) {
      __syncthreads();  // pass p of A is complete; pass p - 1's buffer is free
      if (p + 1 < np) stage(p + 1);
    }
    if (i + BT_XD - 1 < n_i) issue_x(i + BT_XD - 1);
    cp_async_commit();  // group i + BT_XD - 1
    const int v = lane + 32 * i;
    if (v >= nvec) continue;
    const int vl = v - p * (BT_KC / 8);  // the slice within its pass
    const bf16* as = a_s + (p & 1) * BT_KC * 8;
    float xf[BT_ROWS][8];
#pragma unroll
    for (int r = 0; r < BT_ROWS; ++r) bf16x8_to_float(*x_slot(i, r), xf[r]);
    if constexpr (LAYOUT == kBtCols) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float af[8];  // column c at k = 8v .. 8v + 7
        bf16x8_to_float(*reinterpret_cast<const uint4*>(as + c * BT_KC + 8 * vl), af);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int r = 0; r < BT_ROWS; ++r) acc[r][c] = fmaf(xf[r][e], af[e], acc[r][c]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float af[8];  // the 8 columns at k = 8v + e
        bf16x8_to_float(*reinterpret_cast<const uint4*>(as + (8 * vl + ((e + vl) & 7)) * 8), af);
#pragma unroll
        for (int r = 0; r < BT_ROWS; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xf[r][e], af[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < BT_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
#pragma unroll
  for (int r = 0; r < BT_ROWS; ++r) {
    if (lane == r && row0 + r < M) {
      __align__(16) bf16 out[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) out[c] = __float2bfloat16(acc[r][c]);  // zero past R, as A's staged columns
      *reinterpret_cast<uint4*>(t + (long long)(row0 + r) * RT + c0) = *reinterpret_cast<const uint4*>(out);
    }
  }
}

// t = T(x @ A_g) into the (G * rows, RT) scratch t, RT = R rounded up to 8.
int launch_bottleneck(const void* x, const void* a, void* t, int G, int rows, int K, int R, int RT, long long sa0,
                      long long sa1, long long sag, cudaStream_t stream) {
  // 16-byte staging of x's slices when its rows are whole vectors, of A
  // when its 8-column groups are whole and aligned (in every group)
  const bool xv = aligned16(x) && K % 8 == 0, a16 = aligned16(a) && R % 8 == 0 && sag % 8 == 0;
  const int layout = a16 && sa1 == 1 && sa0 % 8 == 0                 ? kBtRows
                     : a16 && sa0 == 1 && sa1 % 8 == 0 && K % 8 == 0 ? kBtCols
                                                                     : kBtScalar;
  using Kernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int, int, long long, long long, long long);
  const Kernel kernels[2][3] = {
      {lora_bottleneck_kernel<kBtScalar, false>, lora_bottleneck_kernel<kBtRows, false>,
       lora_bottleneck_kernel<kBtCols, false>},
      {lora_bottleneck_kernel<kBtScalar, true>, lora_bottleneck_kernel<kBtRows, true>,
       lora_bottleneck_kernel<kBtCols, true>}};
  const Kernel bottleneck = kernels[xv][layout];
  cudaError_t err = cudaFuncSetAttribute(bottleneck, cudaFuncAttributeMaxDynamicSharedMemorySize, BT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G * ((rows + BT_WARPS * BT_ROWS - 1) / (BT_WARPS * BT_ROWS)), RT / 8);
  bottleneck<<<grid, BT_THREADS, BT_SMEM, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(a),
                                                    static_cast<bf16*>(t), rows, K, R, RT, sa0, sa1, sag);
  return static_cast<int>(cudaGetLastError());
}

int launch_wmma(const void* x, const void* w, const void* a, const void* b, void* y, void* t, int G, int rows, int K,
                int N, int R, long long sw0, long long sw1, long long sa0, long long sa1, long long sag, long long sb0,
                long long sb1, long long sbg, float alpha, cudaStream_t stream) {
  const bool row = sw1 == 1 && sa1 == 1 && sb1 == 1;
  const bool col = sw0 == 1 && sa0 == 1 && sb0 == 1;
  if (!row && !col) return -1;  // W, A, B all row-major (forward) or all transposed views (dX)
  if (!aligned16(t)) return -1;
  const long long ldw = row ? sw0 : sw1, ldb = row ? sb0 : sb1;
  const int vec_x = aligned16(x) && K % 8 == 0, vec_y = aligned16(y) && N % 8 == 0;
  const int vec_w = aligned16(w) && ldw % 8 == 0, vec_b = aligned16(b) && ldb % 8 == 0 && sbg % 8 == 0;
  const int RT = (R + 7) / 8 * 8;
  int e = launch_bottleneck(x, a, t, G, rows, K, R, RT, sa0, sa1, sag, stream);
  if (e) return e;
  const dim3 grid((N + WN - 1) / WN, G * ((rows + WM - 1) / WM));
  auto kernel = row ? lora_matmul_wmma_kernel<false> : lora_matmul_wmma_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(WmmaSmem::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the bottleneck's programmatic dependent: it waits for t before its epilogue
  err = launch_dependent(kernel, grid, dim3(WTHREADS), WmmaSmem::bytes, stream, static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w), static_cast<const bf16*>(t), static_cast<const bf16*>(b),
                         static_cast<bf16*>(y), rows, K, N, R, RT, ldw, ldb, sbg, vec_x, vec_w, vec_b, vec_y, alpha);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (2) y = T(x @ W + alpha * t @ B_g).  Shared memory: the ring (x chunks
// 128 x 64, W chunks 64 x 256 as four 64-column sub-tiles or one 256-row
// sub-tile), the RT rows of each B_g that the tile's rows take, for its 256
// columns (MAX_R rows in all), the barriers; the y tile reuses the x chunks.
constexpr int GM = 128;  // a tile's rows (ops.LORA_TILE_ROWS)
constexpr int GN = 256, GK = 64, GSTAGES = 4, GTHREADS = 2 * hopper::WG_THREADS, GROUP_M = 16;

struct GemmLayout {
  static constexpr int x = 0;
  static constexpr int w = x + GSTAGES * GM * GK * 2;
  static constexpr int b = w + GSTAGES * GK * GN * 2;
  static constexpr int bars = b + MAX_R * GN * 2;  // full[GSTAGES], empty[GSTAGES]
  static constexpr int bytes = bars + 16 * GSTAGES + 1024;  // + alignment slack
  static_assert(GM * GN * 2 <= w - x, "the y tile fits in the x chunks");
};

// One 64-deep chunk of this warpgroup's 64 x 256 product.
template <bool B_MN, bool FIRST>
__device__ __forceinline__ void gemm_chunk(float (&acc)[GN / 2], uint32_t xs, uint32_t ws, int cw) {
  using namespace hopper;
  const SmemDesc xd = kmajor_base(xs, 64 * cw);
  const SmemDesc wd = B_MN ? mnmajor_base(ws, GK) : kmajor_base(ws, 0);
#pragma unroll
  for (int kk = 0; kk < GK / 16; ++kk) {
    const uint64_t db = B_MN ? wd.at(mnmajor_step(kk)) : wd.at(kmajor_step(GN, kk));
    if (FIRST && kk == 0) {
      wgmma_ss_init<GN, B_MN ? 1 : 0>(acc, xd.at(kmajor_step(GM, 0)), db);
    } else {
      wgmma_ss<GN, B_MN ? 1 : 0>(acc, xd.at(kmajor_step(GM, kk)), db, 1);
    }
  }
}

// 8 values of t's row (zeros past M) from column g on.
__device__ __forceinline__ void load_t8(const bf16* __restrict__ t, int row, int M, int RT, int g, float (&f)[8]) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (row < M) u = *reinterpret_cast<const uint4*>(t + (long long)row * RT + g);
  bf16x8_to_float(u, f);
}

template <bool B_MN>
__global__ void __launch_bounds__(GTHREADS, 1)
lora_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ty, const bf16* __restrict__ t,
                         const bf16* __restrict__ b, int M, int K, int N, int R, int RT, int G, int rows,
                         long long sb0, long long sb1, long long sbg, float alpha) {
  using namespace hopper;
  using L = GemmLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* x_s = reinterpret_cast<bf16*>(smem + L::x);
  bf16* w_s = reinterpret_cast<bf16*>(smem + L::w);
  bf16* b_s = reinterpret_cast<bf16*>(smem + L::b);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + GSTAGES;

  // this block's tile: groups of GROUP_M row tiles, rows fastest
  const int tiles_m = (M + GM - 1) / GM, tiles_n = (N + GN - 1) / GN;
  const int per_group = GROUP_M * tiles_n, first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(GROUP_M, tiles_m - first_m), in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * GM, n0 = (in_group / group_m) * GN;
  const int cw = warpgroup_index();  // rows [m0 + 64 cw, m0 + 64 cw + 64) of the tile
  const int tid = threadIdx.x % WG_THREADS, lane = tid & 31;
  const bool feeder = threadIdx.x == 0;
  if (feeder) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nk = (K + GK - 1) / GK;
  // chunk c into slot c % GSTAGES once the chunk before it there is done
  auto feed = [&](int c) {
    const int slot = c % GSTAGES;
    mbar_wait(&empty[slot], ((c / GSTAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[slot], (GM * GK + GK * GN) * 2);
    bf16* xs = x_s + slot * GM * GK;
    bf16* ws = w_s + slot * GK * GN;
    tma_load_2d(xs, &tx, &full[slot], c * GK, m0);
    tma_load_2d(xs + 64 * 64, &tx, &full[slot], c * GK, m0 + 64);
#pragma unroll
    for (int i = 0; i < GN / 64; ++i) {
      if constexpr (B_MN) {
        tma_load_2d(ws + i * 64 * 64, &tw, &full[slot], n0 + 64 * i, c * GK);  // W: 64 k x 64 n
      } else {
        tma_load_2d(ws + i * 64 * 64, &tw, &full[slot], c * GK, n0 + 64 * i);  // W^T's rows: 64 n x 64 k
      }
    }
  };
  if (feeder) {
    for (int c = 0; c < nk && c < GSTAGES; ++c) feed(c);
  }
  // the groups g0 .. g0 + ng - 1 of the tile's rows (below M); B_{g0 + s}'s
  // rows for the tile's columns (zero past R and N) at b_s[s * RT ..], for
  // the epilogue
  const int g0 = m0 / rows, ng = (min(m0 + GM, M) - 1) / rows - g0 + 1;
  for (int e = threadIdx.x; e < ng * RT * GN; e += GTHREADS) {
    const int s = e / (RT * GN), f = e % (RT * GN);
    int j, col;
    if (sb1 == 1) {
      j = f / GN;
      col = f % GN;
    } else {
      col = f / RT;
      j = f % RT;
    }
    const bf16* bg = b + (long long)(g0 + s) * sbg;
    b_s[(s * RT + j) * GN + col] =
        j < R && n0 + col < N ? bg[(long long)j * sb0 + (long long)(n0 + col) * sb1] : __float2bfloat16(0.f);
  }

  float acc[GN / 2];
  mbar_wait(&full[0], 0);
  wgmma_fence();
  gemm_chunk<B_MN, true>(acc, smem_u32(x_s), smem_u32(w_s), cw);
  wgmma_commit();
  for (int c = 1; c < nk; ++c) {
    const int slot = c % GSTAGES;
    mbar_wait(&full[slot], (c / GSTAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
    gemm_chunk<B_MN, false>(acc, smem_u32(x_s + slot * GM * GK), smem_u32(w_s + slot * GK * GN), cw);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1 is done: its slot is free
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(c - 1) % GSTAGES]);
    if (feeder && c - 1 + GSTAGES < nk) feed(c - 1 + GSTAGES);
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // both products done (the ring is free for y); b_s complete
  pdl_wait();       // t is written

  // y += alpha * t @ B_g: this thread's rows ra, ra + 8 (each with its own
  // group's staged B; rows past M, whose t is zero, take the last one) and
  // its 64 columns, t @ B summed over 8 ranks at a time (one pass at the
  // port's rank 8)
  const int ra = m0 + 64 * cw + 16 * (tid >> 5) + (lane >> 2);
  const bf16* b0 = b_s + (min(ra, M - 1) / rows - g0) * RT * GN;
  const bf16* b1 = b_s + (min(ra + 8, M - 1) / rows - g0) * RT * GN;
  for (int g = 0; g < RT; g += 8) {
    float t0[8], t1[8];
    load_t8(t, ra, M, RT, g, t0);
    load_t8(t, ra + 8, M, RT, g, t1);
#pragma unroll
    for (int jj = 0; jj < GN / 8; ++jj) {
      const int col = 8 * jj + 2 * (lane & 3);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b0 + (g + j) * GN + col));
        const float2 bv1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b1 + (g + j) * GN + col));
        s0 = fmaf(t0[j], bv0.x, s0);
        s1 = fmaf(t0[j], bv0.y, s1);
        s2 = fmaf(t1[j], bv1.x, s2);
        s3 = fmaf(t1[j], bv1.y, s3);
      }
      acc[4 * jj] += alpha * s0;
      acc[4 * jj + 1] += alpha * s1;
      acc[4 * jj + 2] += alpha * s2;
      acc[4 * jj + 3] += alpha * s3;
    }
  }

  // y rounded once, through this warpgroup's rows of a swizzled tile, by TMA
  bf16* y_s = x_s;
  acc_to_tile<GN>(acc, 1.f, 1.f, y_s, GM, 64 * cw);
  fence_proxy_async();
  named_sync(1 + cw, WG_THREADS);
  if (tid == 0 && m0 + 64 * cw < M) {
#pragma unroll
    for (int i = 0; i < GN / 64; ++i) tma_store_2d(&ty, y_s + (i * GM + 64 * cw) * 64, n0 + 64 * i, m0 + 64 * cw);
    tma_store_flush();
  }
}

// The most groups of `rows` rows that one GM-row tile can touch (mirrored
// by ops.lora_group_span, which sends a refused grouped call to WMMA).
int group_span(int G, int rows) {
  const int span = rows % GM == 0 ? 1 : (GM - 1 + rows - 1) / rows + 1;
  return span < G ? span : G;
}

int launch_wgmma(const void* x, const void* w, const void* a, const void* b, void* y, void* t, int G, int rows,
                 int K, int N, int R, long long sw0, long long sw1, long long sa0, long long sa1, long long sag,
                 long long sb0, long long sb1, long long sbg, float alpha, cudaStream_t stream) {
  const bool b_mn = sw1 == 1 && sw0 % 8 == 0;  // W row-major: the forward
  const bool b_k = sw0 == 1 && sw1 % 8 == 0;   // a transposed view: dX
  if (!b_mn && !b_k) return -1;
  if (K % 8 || N % 8 || !aligned16(x) || !aligned16(w) || !aligned16(y) || !aligned16(t)) return -1;
  const int RT = (R + 7) / 8 * 8, M = G * rows;
  if (group_span(G, rows) * RT > MAX_R) return -1;  // the B_g a tile takes would not fit
  int e = launch_bottleneck(x, a, t, G, rows, K, R, RT, sa0, sa1, sag, stream);
  if (e) return e;
  CUtensorMap tx, tw, ty;
  e = hopper::make_map_2d(&tx, x, K, M, K);
  if (!e) e = b_mn ? hopper::make_map_2d(&tw, w, N, K, sw0) : hopper::make_map_2d(&tw, w, K, N, sw1);
  if (!e) e = hopper::make_map_2d(&ty, y, N, M, N);
  if (e) return e;
  auto kernel = b_mn ? lora_matmul_wgmma_kernel<true> : lora_matmul_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmLayout::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // launched as the bottleneck's programmatic dependent: its main loop may
  // start before the bottleneck ends, and it waits for t before the epilogue
  const unsigned tiles = static_cast<unsigned>((long long)((M + GM - 1) / GM) * ((N + GN - 1) / GN));
  err = launch_dependent(kernel, dim3(tiles), dim3(GTHREADS), GemmLayout::bytes, stream, tx, tw, ty,
                         static_cast<const bf16*>(t), static_cast<const bf16*>(b), M, K, N, R, RT, G, rows, sb0, sb1,
                         sbg, alpha);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route codes, shared with repro_torch/kernels/ops.py.
enum LoraRoute { kRouteFma = 0, kRouteWmma = 1, kRouteWgmma = 2 };

// Returns 0 on a good launch, the cudaError_t of a refused launch, -1 for
// arguments the route does not take, or -2 if CUDA refuses a tensor map.
// G groups of M / G rows (G divides M); sag and sbg are A's and B's group
// strides (unused at G = 1).  t: the bf16 routes' (M, ceil(r / 8) * 8) bf16
// scratch for the bottleneck, 16-byte aligned (unused by the float32
// route).  Shapes, dtypes, devices and x's contiguity are checked by the
// Python wrapper.
extern "C" int lora_matmul_launch(int dtype, int route, const void* x, const void* w, const void* a, const void* b,
                                  void* y, void* t, int M, int K, int N, int R, int G, long long sw0, long long sw1,
                                  long long sa0, long long sa1, long long sag, long long sb0, long long sb1,
                                  long long sbg, float alpha, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || R <= 0 || R > MAX_R || G <= 0 || M % G) return -1;
  const int rows = M / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma && dtype == kBFloat16)
    return launch_wgmma(x, w, a, b, y, t, G, rows, K, N, R, sw0, sw1, sa0, sa1, sag, sb0, sb1, sbg, alpha, s);
  if ((long long)G * ((rows + 31) / 32) > 65535) return -1;
  if (route == kRouteFma && dtype == kFloat32)
    return launch_fma(x, w, a, b, y, G, rows, K, N, R, sw0, sw1, sa0, sa1, sag, sb0, sb1, sbg, alpha, s);
  if (route == kRouteWmma && dtype == kBFloat16)
    return launch_wmma(x, w, a, b, y, t, G, rows, K, N, R, sw0, sw1, sa0, sa1, sag, sb0, sb1, sbg, alpha, s);
  return -1;
}

// Dynamic shared memory a wgmma-route launch asks for (for reports).
extern "C" int lora_matmul_wgmma_smem_bytes() { return GemmLayout::bytes; }
