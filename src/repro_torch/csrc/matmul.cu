// Rank-batched matrix product with an f32 accumulator:
//
//     C[r] (M x N) = A[r] (M x K) . B[r] (K x N)
//
// Hopper counterpart of `matmul_pallas` (src/repro/kernels/collective_matmul.py:43),
// the (bm, bk, bn)-tiled Pallas product that keeps an f32 accumulator in VMEM
// across its sequential k grid steps and writes x.dtype once. On the GPU the
// k loop runs inside each block (blocks run in parallel and carry nothing
// between them), and the sum is rounded once to the element type at the end.
// A, B and C are given by element strides (rank, row, column), so transposed
// views (the backward products dY . W^T and X^T . dY, and the tied head
// embed^T) need no copy, a rank stride of 0 reads one matrix for every rank
// (a replicated weight; the allgather-matmul's rows), and a product can land
// in a strided view of a larger output.
//
// Bound. At smollm-135m's widths the products sit at the card's ridge: a
// forward product of the training step, (8, 1024, 576) x (8, 576, 1536),
// does 298 flops per byte it must move, the ridge of 989 TFLOP/s bf16 over
// 3.35 TB/s is 295; the tied head's products (K or N = 49152) are bound by
// operations, decode's M = 1 products by bytes. So the tensor cores' full
// rate, which Hopper gives only through wgmma, and loads that cost the
// multiplying threads nothing are what the bf16 path needs. Three kernels:
//   - bf16, wgmma + TMA (the path of every bf16 product on the main path).
//     A persistent grid, one block per SM, walks the output tiles of 128 x
//     192, one 64-row half to each of two consumer warpgroups. 192 divides
//     every width of the model (192, 576, 1536, 49152), 64 every row count
//     but decode's. A producer warp keeps TMA loads of 64 x 64 boxes with
//     128-byte swizzle in flight into a ring of 4 stages of A and B tiles in
//     dynamic shared memory, each stage with a full and an empty mbarrier;
//     it walks on into the next tile while the consumers store the last
//     one. Each consumer warpgroup runs wgmma m64n192k16 on its 64 rows, the
//     f32 accumulator (96 registers a thread) in registers; setmaxnreg gives
//     the producer's registers to them. Each
//     rounds its tile to bf16 into shared memory, and TMA stores write it
//     out while the warpgroup goes on to the next tile (an output TMA cannot
//     describe is stored element pairs at a time through its strides). An
//     operand with its K dim contiguous is read K-major, one with its M (N)
//     dim contiguous MN-major through wgmma's transpose bit: the backward's
//     and the head's transposed views need no copy. Ragged M, N and K edges
//     are zero-filled by TMA on load and masked on store; an operand with a
//     rank stride of 0 is read without a rank coordinate. The wrapper takes
//     this path where TMA can describe both operands (a 16-byte-aligned base,
//     a unit stride on one inner dim, every other stride a multiple of 16
//     bytes); the tensor maps are encoded on the host per call through the
//     driver's entry point, so nothing links libcuda.
//   - bf16, nvcuda::wmma 16x16x16 (the operands TMA cannot describe: K or N
//     not a multiple of 8, a base off a 16-byte boundary). A 128 x 128 block
//     tile, 8 warps of 64 x 32 each, k steps of 32 in a two-stage
//     shared-memory pipeline: 16-byte cp.async copies of step t + 1 fly
//     while step t multiplies (padded by 8 elements against bank
//     conflicts). Operands whose unit-stride extent is not a multiple of 8,
//     or that are not 16-byte aligned, are copied element by element.
//   - f32: CUDA-core FMAs (wmma has no full-f32 product, and TF32 would drop
//     mantissa bits). A 64 x 64 block tile, 4 x 4 outputs per thread, k steps
//     of 16.
// Each output element sums its k terms in one fixed order, with no split-K
// and no atomics, whatever tile, rank or row it lies in: the result is
// deterministic, and a row's result does not depend on the rows beside it.
#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// ------------------------------------------------------ bf16, wgmma + TMA

constexpr int WN = 192;                   // block tile width, one wgmma's N
constexpr int WK = 64;                    // k step: 64 bf16 = one 128-byte swizzle row
constexpr int kBox = 64;                  // every TMA box is 64 x 64 elements
constexpr int kBoxBytes = kBox * WK * 2;  // 8192
constexpr int kSwizzleAtom = 1024;        // 8 rows of 128 bytes
constexpr unsigned long long kWatchdogNs = 10000000000ull;

// NC consumer warpgroups of 64 rows each, then one producer warpgroup.
// Shared memory: the ring of stages, then each consumer's 64 x 192 output
// tile on its way out (3 boxes), then the barriers.
constexpr int NC = 2;
struct WgmmaTile {
  static constexpr int kStages = 4;
  static constexpr int kABytes = NC * kBoxBytes;
  static constexpr int kStageBytes = kABytes + (WN / kBox) * kBoxBytes;
  static constexpr int kOutBytes = (WN / kBox) * kBoxBytes;
  static constexpr int kSmem =
      kStages * kStageBytes + NC * kOutBytes + 2 * kStages * 8 + kSwizzleAtom;
  static constexpr int kThreads = (NC + 1) * 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the completion of the barrier's phase of this parity. A wrong
// parity would hang the block, so a wait that lasts 10 s traps: the launch
// then fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(a, parity))
    if (global_ns() - t0 > kWatchdogNs) __trap();
}

// One 64 x 64 box of a 3-D tensor map (inner, outer, rank) into shared
// memory; the barrier counts its bytes (the whole box, zeros past an edge).
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One 64 x 64 box from shared memory to a 3-D tensor map, in the bulk group
// of the issuing thread; TMA writes nothing outside the tensor's extents.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const uint8_t* src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the 128 threads of one warpgroup (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most N groups still in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of an accumulator register across a wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D (64 x 192, f32) (+)= A (64 x 16) . B (16 x 192), both from shared memory;
// TA / TB: the operand is MN-major (wgmma's transpose bit).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da, uint64_t db,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// A stage holds NC boxes of A (64 rows each, one per consumer warpgroup)
// and 3 boxes of B (64 columns each). A K-major box is 64 rows (m or n) of
// 128 bytes of k; an MN-major box 64 k-rows of 128 bytes of m or n. In both,
// 8-row swizzle atoms lie 1024 bytes apart (SBO); the 3 MN-major boxes of B
// lie one box apart along n (LBO). A k step of 16 moves a K-major
// descriptor 32 bytes along its rows and an MN-major one 16 rows down.
template <bool AK, bool BKM>
__global__ void __launch_bounds__(WgmmaTile::kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc, int a_ranked, int b_ranked,
                    int c_tma, __nv_bfloat16* __restrict__ c, long long scr, long long scm,
                    long long scn, int c_pairs, int r, int m, int n, int k) {
  using T = WgmmaTile;
  constexpr int BMT = 64 * NC;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on a 1024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  uint8_t* out_tiles = smem + T::kStages * T::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + NC * T::kOutBytes);
  uint64_t* empty = full + T::kStages;

  const int tiles_m = (m + BMT - 1) / BMT, tiles_n = (n + WN - 1) / WN;
  const int tiles = tiles_m * tiles_n * r;
  const int nk = (k + WK - 1) / WK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 4 * NC);      // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tiles walk M fastest: neighbouring blocks share B's columns (the head's
  // 49152-wide embedding is read about once) and A's rows stay in L2
  if (wg == NC) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * BMT, n0 = (t / tiles_m % tiles_n) * WN;
        const int rank = t / (tiles_m * tiles_n);
        const int za = a_ranked ? rank : 0, zb = b_ranked ? rank : 0;
        for (int kb = 0; kb < nk; ++kb) {
          const int k0 = kb * WK;
          mbar_wait(&empty[stage], phase ^ 1);   // the first round passes at once
          mbar_expect_tx(&full[stage], T::kStageBytes);
          uint8_t* as = smem + stage * T::kStageBytes;
          uint8_t* bs = as + T::kABytes;
#pragma unroll
          for (int h = 0; h < NC; ++h) {
            if (AK)
              tma_load(as + h * kBoxBytes, &ta, &full[stage], k0, m0 + 64 * h, za);
            else
              tma_load(as + h * kBoxBytes, &ta, &full[stage], m0 + 64 * h, k0, za);
          }
#pragma unroll
          for (int j = 0; j < WN / kBox; ++j) {
            if (BKM)
              tma_load(bs + j * kBoxBytes, &tb, &full[stage], k0, n0 + 64 * j, zb);
            else
              tma_load(bs + j * kBoxBytes, &tb, &full[stage], n0 + 64 * j, k0, zb);
          }
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    int stage = 0, held = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % tiles_m) * BMT, n0 = (t / tiles_m % tiles_n) * WN;
      const int rank = t / (tiles_m * tiles_n);
      // one k step's products stay in flight while the next is issued; a
      // stage goes back to the producer once the products reading it are done
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t as = smem_u32(smem + stage * T::kStageBytes + wg * kBoxBytes);
        const uint32_t bs = smem_u32(smem + stage * T::kStageBytes + T::kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) {
          const uint64_t da = AK ? smem_desc(as + kk * 32, 16, kSwizzleAtom)
                                 : smem_desc(as + kk * 16 * 128, kBoxBytes, kSwizzleAtom);
          const uint64_t db = BKM ? smem_desc(bs + kk * 32, 16, kSwizzleAtom)
                                  : smem_desc(bs + kk * 16 * 128, kBoxBytes, kSwizzleAtom);
          wgmma_m64n192k16<AK ? 0 : 1, BKM ? 0 : 1>(acc, da, db, (kb | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 96; ++i) reg_fence(acc[i]);
      if (lane == 0) mbar_arrive(&empty[held]);
      // epilogue: thread (warp, lane) holds rows warp*16 + lane/4 (+8) and
      // column pairs 8j + 2 (lane % 4) of its warpgroup's 64 x 192 tile.
      // Where TMA can write C, the tile goes through shared memory, laid out
      // as three 128-byte-swizzled 64 x 64 boxes (conflict-free: the 8 rows
      // of a store land in 8 different 16-byte chunks), and out by TMA
      // stores that run on while the warpgroup multiplies the next tile.
      if (c_tma) {
        uint8_t* tile = out_tiles + wg * T::kOutBytes;
        const bool leader = threadIdx.x % 128 == 0;
        if (leader)   // the last tile's stores have read the buffer
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        warpgroup_sync(wg);
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 16 + lane / 4 + 8 * h;
            const int off = (j / 8) * kBoxBytes + row * 128 + (((j % 8) ^ (row % 8)) * 16) +
                            (lane % 4) * 4;
            *reinterpret_cast<__nv_bfloat162*>(tile + off) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(wg);
        if (leader) {
#pragma unroll
          for (int j = 0; j < WN / kBox; ++j)
            tma_store(&tc, tile + j * kBoxBytes, n0 + kBox * j, m0 + 64 * wg, rank);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        continue;
      }
      __nv_bfloat16* cr = c + rank * scr;
      const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = row + 8 * h;
          if (gm >= m || col >= n) continue;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          __nv_bfloat16* p = cr + gm * scm + col * scn;
          if (c_pairs && col + 1 < n) {
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
          } else {
            p[0] = __float2bfloat16_rn(v0);
            if (col + 1 < n) p[scn] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    if (c_tma && threadIdx.x % 128 == 0)   // the stores are done before the block ends
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at first use
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 20000;   // + the entry point's query result
constexpr int kErrEncode = 10000;       // + the CUresult of the encoder

int encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (q != cudaDriverEntryPointSuccess || !p) return kErrEntryPoint + static_cast<int>(q);
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return 0;
}

// A bf16 matrix (an operand, or the output) as a 3-D tensor map (inner,
// outer, rank) of 64 x 64 x 1 boxes with 128-byte swizzle. Strides in
// elements; rank_stride 0 gives the map one rank (for an operand: one matrix
// that every rank reads, at rank coordinate 0).
int encode_operand(CUtensorMap* map, const void* base, long long inner, long long outer,
                   long long outer_stride, long long ranks, long long rank_stride) {
  EncodeTiled fn;
  if (const int err = encoder(&fn)) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(rank_stride ? ranks : 1)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(outer_stride) * 2,
                                 static_cast<cuuint64_t>(rank_stride ? rank_stride
                                                                     : outer_stride * outer) * 2};
  const cuuint32_t box[3] = {kBox, kBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

template <bool AK, bool BKM>
void launch_wgmma(cudaStream_t st, const CUtensorMap& ta, const CUtensorMap& tb,
                  const CUtensorMap& tc, int a_ranked, int b_ranked, int c_tma, void* c,
                  long long scr, long long scm, long long scn, int c_pairs, int r, int m, int n,
                  int k) {
  using T = WgmmaTile;
  static int sms[64] = {};   // device d's SM count, once its shared-memory limit is raised
  int dev = 0;
  cudaGetDevice(&dev);
  int count = dev < 64 ? sms[dev] : 0;
  if (!count) {
    cudaFuncSetAttribute(matmul_wgmma_kernel<AK, BKM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms[dev] = count;
  }
  const long long tiles =
      static_cast<long long>((m + 64 * NC - 1) / (64 * NC)) * ((n + WN - 1) / WN) * r;
  const int grid = static_cast<int>(tiles < count ? tiles : count);
  matmul_wgmma_kernel<AK, BKM><<<grid, T::kThreads, T::kSmem, st>>>(
      ta, tb, tc, a_ranked, b_ranked, c_tma, static_cast<__nv_bfloat16*>(c), scr, scm, scn,
      c_pairs, r, m, n, k);
}

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

// The wmma (dtype 1, bf16) and FMA (dtype 0, f32) paths. Returns
// cudaGetLastError() after the launch (0 on success); strides are in elements. The caller checks arguments: r <=
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

// The bf16 wgmma path. Each operand comes as (k_major, outer stride, rank
// stride) in elements, from the wrapper's check that TMA can describe it:
// A (R, M, K) is K-major when its K dim is contiguous (outer stride: its M
// stride), else MN-major (outer stride: its K stride); B (R, K, N) is
// K-major when its K dim is contiguous (outer: its N stride), else MN-major
// (outer: its K stride). A rank stride of 0 reads one matrix for every
// rank. Returns 0, a cudaError after the launch, or kErrEncode /
// kErrEntryPoint plus the driver's code. The persistent grid has
// min(tiles, SMs) blocks.
extern "C" int matmul_wgmma(const void* a, int a_kmajor, long long a_outer, long long a_rank,
                            const void* b, int b_kmajor, long long b_outer, long long b_rank,
                            void* c, long long scr, long long scm, long long scn, int r, int m,
                            int n, int k, void* stream) {
  CUtensorMap ta, tb;
  int err = a_kmajor ? encode_operand(&ta, a, k, m, a_outer, r, a_rank)
                     : encode_operand(&ta, a, m, k, a_outer, r, a_rank);
  if (err) return err;
  err = b_kmajor ? encode_operand(&tb, b, k, n, b_outer, r, b_rank)
                 : encode_operand(&tb, b, n, k, b_outer, r, b_rank);
  if (err) return err;
  const int c_pairs = scn == 1 && scm % 2 == 0 && scr % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(c) & 3) == 0;
  // TMA writes C where it can describe it: a 16-byte-aligned base, unit
  // column stride, row and rank strides multiples of 16 bytes (a single row
  // or rank takes any); else each thread stores its own elements
  const bool one_row = m == 1, one_rank = r == 1;
  const int c_tma = (reinterpret_cast<uintptr_t>(c) & 15) == 0 && scn == 1 &&
                    (one_row || (scm > 0 && scm % 8 == 0)) &&
                    (one_rank || (scr > 0 && scr % 8 == 0));
  CUtensorMap tc = {};
  if (c_tma) {
    const long long row_stride = one_row ? (n + 7) / 8 * 8 : scm;
    if ((err = encode_operand(&tc, c, n, m, row_stride, r, one_rank ? 0 : scr))) return err;
  }
  using Launch = void (*)(cudaStream_t, const CUtensorMap&, const CUtensorMap&,
                          const CUtensorMap&, int, int, int, void*, long long, long long,
                          long long, int, int, int, int, int);
  static const Launch table[2][2] = {{launch_wgmma<false, false>, launch_wgmma<false, true>},
                                     {launch_wgmma<true, false>, launch_wgmma<true, true>}};
  table[a_kmajor ? 1 : 0][b_kmajor ? 1 : 0](
      static_cast<cudaStream_t>(stream), ta, tb, tc, a_rank != 0, b_rank != 0, c_tma, c, scr,
      scm, scn, c_pairs, r, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
