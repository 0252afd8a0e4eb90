// Rank-batched matrix product with an f32 accumulator:
//
//     C[r] (M x N) = A[r] (M x K) . B[r] (K x N)
//
// Hopper counterpart of `matmul_pallas` (src/repro/kernels/collective_matmul.py:43),
// the (bm, bk, bn)-tiled Pallas product that keeps an f32 accumulator in VMEM
// across its sequential k grid steps and writes x.dtype once. On the GPU the
// k loop runs inside each block (blocks run in parallel and carry nothing
// between them), each block owns one output tile of one rank (blockIdx.z),
// and the sum is rounded once to the element type at the end.
//
// A, B and C are given by element strides (rank, row, column), so transposed
// views (the backward products dY . W^T and X^T . dY, and the tied head
// embed^T) need no copy, and a product can land in a strided view of a
// larger output (the diagonals of the allgather-matmul's output). Each operand's tile is kept in shared memory along
// that operand's unit-stride dim and read back as a row- or col-major
// fragment, so either layout is read coalesced; any element outside M, N or
// K is loaded as zero, so no dim need divide a tile.
//
// Bound: operations. A forward product of smollm-135m at batch 16 x 512 does
// 2 * R * M * N * K flops on (R, 1024, 576) x (R, 576, 1536) operands, far
// above the card's 295 flops per byte of bf16, so the tensor cores are the
// limit:
//   - bf16: nvcuda::wmma 16x16x16 tensor-core products. A 128 x 128 block
//     tile, 8 warps of 64 x 32 each, k steps of 32 in a two-stage
//     shared-memory pipeline: 16-byte cp.async copies of step t + 1 fly
//     while step t multiplies (padded by 8 elements against bank
//     conflicts). Operands whose unit-stride extent is not a multiple of 8,
//     or that are not 16-byte aligned, are copied element by element.
//   - f32: CUDA-core FMAs (wmma has no full-f32 product, and TF32 would drop
//     mantissa bits). A 64 x 64 block tile, 4 x 4 outputs per thread, k steps
//     of 16.
// Each output element sums its k terms in a fixed order, with no split-K and
// no atomics: the result is deterministic. wgmma, TMA and a deeper ring of
// tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// ------------------------------------------------------------- bf16, wmma

constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group have landed
}

// One operand tile of a stage: ROWS x COLS (+PAD) elements in shared memory,
// COLS along the operand's unit-stride dim, so that 16-byte chunks copy
// straight from global memory. `r_stride` / `c_stride` are the global
// strides of the tile's rows and columns, `r_lim` / `c_lim` their extents.
// With `vec`, every chunk is one cp.async (zero-filled past the edge; the
// wrapper guarantees the extent along COLS is a multiple of 8 and the
// addresses are 16-byte aligned); otherwise element by element.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long r_stride, long long c_stride, int r0,
                                          int c0, int r_lim, int c_lim, bool vec, int tid) {
  constexpr int kChunks = COLS / 8;
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int row = i / kChunks, col = (i % kChunks) * 8;
    const int gr = r0 + row, gc = c0 + col;
    __nv_bfloat16* d = dst + row * (COLS + PAD) + col;
    if (vec) {
      const bool in = gr < r_lim && gc < c_lim;
      cp_async16(d, in ? src + gr * r_stride + gc * c_stride : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < r_lim && gc + e < c_lim) ? src[gr * r_stride + (gc + e) * c_stride]
                                              : __ushort_as_bfloat16(0);
    }
  }
}

// AK: A's tile is stored m-major (k contiguous: a row-major operand); else
// k-major (m contiguous: a transposed view), read as a col-major fragment.
// BNF: B's tile is stored k-major (n contiguous); else n-major (k
// contiguous, e.g. W^T or embed^T), read as a col-major fragment.
template <bool AK, bool BNF>
__global__ void __launch_bounds__(kThreads, 2)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ a, long long sar, long long sam,
                   long long sak, bool vec_a, const __nv_bfloat16* __restrict__ b,
                   long long sbr, long long sbk, long long sbn, bool vec_b,
                   __nv_bfloat16* __restrict__ c, long long scr, long long scm,
                   long long scn, int m, int n, int k) {
  constexpr int A_ROWS = AK ? BM : BK, A_COLS = AK ? BK : BM;
  constexpr int B_ROWS = BNF ? BK : BN, B_COLS = BNF ? BN : BK;
  constexpr int A_STAGE = A_ROWS * (A_COLS + PAD), B_STAGE = B_ROWS * (B_COLS + PAD);
  using ALayout = typename std::conditional<AK, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<BNF, wmma::row_major, wmma::col_major>::type;
  // two stages of A and B tiles; after the k loop the first 8 KB stage
  // each warp's 16 x 16 f32 accumulator tile on its way out
  __shared__ __align__(128) __nv_bfloat16 smem[2 * (A_STAGE + B_STAGE)];
  static_assert(2 * (A_STAGE + B_STAGE) * 2 >= (kThreads / 32) * 256 * 4, "epilogue space");
  __nv_bfloat16* as = smem;
  __nv_bfloat16* bs = smem + 2 * A_STAGE;

  const long long r = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += r * sar;
  b += r * sbr;
  c += r * scr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // this warp's 64 x 32 sub-tile

  auto load = [&](int k0, int stage) {
    if (AK)
      load_tile<A_ROWS, A_COLS>(as + stage * A_STAGE, a, sam, sak, m0, k0, m, k, vec_a, tid);
    else
      load_tile<A_ROWS, A_COLS>(as + stage * A_STAGE, a, sak, sam, k0, m0, k, m, vec_a, tid);
    if (BNF)
      load_tile<B_ROWS, B_COLS>(bs + stage * B_STAGE, b, sbk, sbn, k0, n0, k, n, vec_b, tid);
    else
      load_tile<B_ROWS, B_COLS>(bs + stage * B_STAGE, b, sbn, sbk, n0, k0, n, k, vec_b, tid);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // two-stage pipeline: the copies of k step t + 1 fly while step t multiplies
  const int nk = (k + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) load((t + 1) * BK, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* at = as + st * A_STAGE;
    const __nv_bfloat16* bt = bs + st * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm + i * 16;
        wmma::load_matrix_sync(fa[i], AK ? at + row * (A_COLS + PAD) + kk
                                         : at + kk * (A_COLS + PAD) + row, A_COLS + PAD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn + j * 16;
        wmma::load_matrix_sync(fb[j], BNF ? bt + kk * (B_COLS + PAD) + col
                                          : bt + col * (B_COLS + PAD) + kk, B_COLS + PAD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + i * 16 + e / 16, gn = n0 + wn + j * 16 + e % 16;
        if (gm < m && gn < n) c[gm * scm + gn * scn] = __float2bfloat16_rn(cs[e]);
      }
      __syncwarp();
    }
}

template <bool AK, bool BNF>
void launch_bf16(dim3 grid, cudaStream_t st, const void* a, long long sar, long long sam,
                 long long sak, bool vec_a, const void* b, long long sbr, long long sbk,
                 long long sbn, bool vec_b, void* c, long long scr, long long scm,
                 long long scn, int m, int n, int k) {
  matmul_bf16_kernel<AK, BNF><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), sar, sam, sak, vec_a,
      static_cast<const __nv_bfloat16*>(b), sbr, sbk, sbn, vec_b,
      static_cast<__nv_bfloat16*>(c), scr, scm, scn, m, n, k);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------- f32, FMA

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kThreads)
matmul_f32_kernel(const float* __restrict__ a, long long sar, long long sam, long long sak,
                  const float* __restrict__ b, long long sbr, long long sbk, long long sbn,
                  float* __restrict__ c, long long scr, long long scm, long long scn, int m,
                  int n, int k) {
  __shared__ float as[FK][FM + 4];  // k-major: a thread reads 4 rows of one k at once
  __shared__ float bs[FK][FN + 4];

  const long long r = blockIdx.z;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  a += r * sar;
  b += r * sbr;
  c += r * scr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // outputs (ty + 16i, tx + 16j)
  const bool a_k_fast = sak == 1;
  const bool b_n_fast = sbn == 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += FK) {
    for (int i = tid; i < FM * FK; i += kThreads) {
      const int mm = a_k_fast ? i / FK : i % FM;
      const int kk = a_k_fast ? i % FK : i / FM;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < m && gk < k) ? a[gm * sam + gk * sak] : 0.0f;
    }
    for (int i = tid; i < FK * FN; i += kThreads) {
      const int kk = b_n_fast ? i / FN : i % FK;
      const int nn = b_n_fast ? i % FN : i / FK;
      const int gk = k0 + kk, gn = n0 + nn;
      bs[kk][nn] = (gk < k && gn < n) ? b[gk * sbk + gn * sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float va[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) va[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(va[i], vb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < m && gn < n) c[gm * scm + gn * scn] = acc[i][j];
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). dtype 0 is f32,
// 1 is bf16; strides are in elements. The caller checks arguments: r <=
// 65535, m, n, k >= 1, m < 65535 * 128, and a c whose elements do not
// overlap.
extern "C" int matmul(int dtype, const void* a, long long sar, long long sam, long long sak,
                      const void* b, long long sbr, long long sbk, long long sbn, void* c,
                      long long scr, long long scm, long long scn, int r, int m, int n, int k,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, r);
    // each operand's tile is stored along its unit-stride dim; 16-byte
    // copies where that dim's extent and the other strides allow them
    const bool ak = sak == 1 || sam != 1, bnf = sbn == 1 || sbk != 1;
    const bool vec_a = aligned16(a) && sar % 8 == 0 &&
                       (ak ? sak == 1 && k % 8 == 0 && sam % 8 == 0
                           : sam == 1 && m % 8 == 0 && sak % 8 == 0);
    const bool vec_b = aligned16(b) && sbr % 8 == 0 &&
                       (bnf ? sbn == 1 && n % 8 == 0 && sbk % 8 == 0
                            : sbk == 1 && k % 8 == 0 && sbn % 8 == 0);
    using Launch = void (*)(dim3, cudaStream_t, const void*, long long, long long, long long,
                            bool, const void*, long long, long long, long long, bool, void*,
                            long long, long long, long long, int, int, int);
    const Launch launch = ak ? (bnf ? launch_bf16<true, true> : launch_bf16<true, false>)
                             : (bnf ? launch_bf16<false, true> : launch_bf16<false, false>);
    launch(grid, st, a, sar, sam, sak, vec_a, b, sbr, sbk, sbn, vec_b, c, scr, scm, scn, m, n,
           k);
  } else if (dtype == 0) {
    const dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM, r);
    matmul_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), sar, sam, sak, static_cast<const float*>(b), sbr, sbk,
        sbn, static_cast<float*>(c), scr, scm, scn, m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
