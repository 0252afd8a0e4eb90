// Packed arrival bitmaps: pack, OR across rows, popcount.
//
// Hopper counterparts of `bitmap_pack` (src/repro/kernels/bitmap.py:40) and
// `bitmap_popcount` (src/repro/kernels/bitmap.py:78), plus the OR of packed
// rows that the packet engine computes for the aggregated NACK
// (src/repro/core/packet.py:952, what the switches do hop by hop), which has
// no TPU kernel. The word format is the reference's: bit i of word w is
// flag[32 * w + i].
//
// - pack: bound by the flag bytes it reads. Each lane loads 16 bytes with
//   one vector load, neighbouring lanes on neighbouring addresses, four
//   vectors in flight a lane: 16 one-byte flags (bool / uint8) or 4
//   four-byte flags (int32 / uint32). A flag is set when it is not 0:
//   one-byte flags are compared first (__vcmpne4, so a uint8 of 2 to 255
//   sets its bit), then each byte's 0/1 is gathered into 4 bits by one
//   multiply; four-byte flags compare as words. The 2 lanes (one-byte) or
//   8 lanes (four-byte) that share a word OR their parts with shuffles, and
//   the first of them stores it. The grid is sized to the SMs and strides
//   over the flags. The first design (one warp per word, a flag a lane and
//   a __ballot_sync) moved 32 bytes a warp load and sat at 8x its bound at
//   (511, 16384): 0.0220 ms on the device against 0.0028, where this one
//   takes 0.0038 (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6). A
//   flag base off 16 bytes (a view with a storage offset)
//   takes that warp-per-word kernel: the C entry checks the address, so no
//   vector load is ever misaligned; once the base is aligned every word's
//   flags are, each word starting 32 flags further on.
// - OR across rows (the aggregated NACK, a few hundred rows of 512 words
//   on the packet path): one launch, a block per column tile of kOrCols
//   vectors (16-byte vectors of 4 words where the words' and the output's
//   bases are 16-byte aligned and a row is a whole number of vectors, else
//   single words; the C entry checks). A block's kOrThreads threads are
//   kOrLanes row lanes of the tile's columns; lane l loads rows l + k
//   kOrLanes (k < kOrInFlight, all in flight) a pass, a pass kOrLanes x
//   kOrInFlight rows (broadcast A's 511 in one), looping until the rows
//   end, so rows have no limit. The lanes of a warp OR their registers by
//   shuffles, the warps' partials meet in shared memory after one
//   barrier, and warp 0 ORs them and stores the tile with plain stores. So
//   a call is one launch into an output from torch.empty: no zero fill, no
//   atomics, and 0 rows stores zeros. The first design (a thread a word
//   column ORing 32 rows, then an atomicOr into a zeroed output) was 32
//   blocks, a fill and an atomic pass: 0.0069 ms on the device and 0.0230
//   from Python at (511, 512), against a 0.0003 bound (NVIDIA H100 80GB
//   HBM3 at 700 W; PERF.md section 6). Thread-block clusters (a cluster a
//   tile, its blocks' partials ORed by the leader through distributed
//   shared memory) were tried at 4 to 16 blocks a cluster and 8 to 32
//   vectors a tile: every one was slower than this at each of the run's
//   shapes, where the call is a launch and a cluster's launch costs more.
// - popcount per row (`bitmap_popcount` at bitmap.py:78 is the one-row
//   case): strips of kStripWords (4,096) words, a block of 512 threads
//   each: __popc per word, warp shuffles, shared memory. A row of up to
//   kStripWords words is one strip, and its block stores the row's total
//   directly: no atomic and no zero fill of the output. Broadcast A's NACK
//   bitmap, 512 words, is such a row: a word a thread. A longer row takes
//   up to one strip block per SM, each ending with one 64-bit atomicAdd
//   into the row's count, which the same C call first zeroes with
//   cudaMemsetAsync. Either way a call from Python is one ctypes call and
//   one launch.
//
// Bound: HBM bytes, all three: the flag bytes for pack (plus 4 B per word
// written), 4 B per word read for OR (plus 4 B per word written) and
// popcount (plus 8 B per row count written). At 512 words the popcount's
// bound is 6e-7 ms at the H100 SXM's data-sheet 3.35 TB/s, and the OR's
// 3e-4 at (511, 512), far under a launch: what a call costs is its launch
// path, so the design spends one launch and nothing else on it. The same
// holds for the replay's single-row pack (16,384 flags): its C entry
// reads the SM count once and caches it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOrThreads = 512;                  // an OR block
constexpr int kOrCols = 4;                       // vectors (or words) of its column tile
constexpr int kOrLanes = kOrThreads / kOrCols;   // its row lanes
constexpr int kOrInFlight = 4;                   // rows a lane loads before it ORs them
constexpr long long kMaxBlocks = 65535;
constexpr unsigned kStripBlocks = 132;  // blocks per row at most: one per SM
constexpr int kPopThreads = 512;                      // a popcount block
constexpr long long kStripWords = kPopThreads * 8LL;  // words it sums (8 a thread)

constexpr int kVecUnroll = 4;        // 16-byte vectors a lane loads before it packs
constexpr int kPackBlocksPerSm = 8;  // 2,048 threads an SM

// the 16 bits of 16 one-byte flags (flag k -> bit k), or the 4 of 4 four-byte ones
template <int kFlagBytes>
__device__ __forceinline__ unsigned vector_bits(uint4 v) {
  if constexpr (kFlagBytes == 1) {
    unsigned bits = 0;
    const unsigned q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // 1 in each byte that is not 0; the multiply moves byte b's 1 to bit
      // 24 + b with no carries (every partial product has its own bit)
      const unsigned ones = __vcmpne4(q[k], 0u) & 0x01010101u;
      bits |= ((ones * 0x01020408u) >> 24) << (4 * k);
    }
    return bits;
  } else {
    return (v.x != 0u) | (v.y != 0u) << 1 | (v.z != 0u) << 2 | (v.w != 0u) << 3;
  }
}

template <int kFlagBytes>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint4* __restrict__ flags, uint32_t* __restrict__ words, long long n_vec) {
  constexpr int kPerLane = 16 / kFlagBytes;  // flags a vector holds
  constexpr int kGroup = 32 / kPerLane;      // lanes a word takes: 2 or 8
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * kVecUnroll;
  // warp-uniform loop: a warp takes kVecUnroll x 32 consecutive vectors;
  // n_vec is a multiple of kGroup, so a lane group is all in or all out
  for (long long v0 = warp * 32 * kVecUnroll; v0 < n_vec; v0 += stride) {
    uint4 v[kVecUnroll];
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      const long long i = v0 + u * 32 + lane;
      v[u] = i < n_vec ? __ldcs(flags + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVecUnroll; ++u) {
      unsigned bits = vector_bits<kFlagBytes>(v[u]) << (kPerLane * (lane % kGroup));
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        bits |= __shfl_xor_sync(0xffffffffu, bits, off);
      const long long i = v0 + u * 32 + lane;
      if (lane % kGroup == 0 && i < n_vec) words[i / kGroup] = bits;
    }
  }
}

// a flag base off 16 bytes: one warp per word, a flag a lane
template <typename T>
__global__ void pack_kernel_unaligned(const T* __restrict__ flags,
                                      uint32_t* __restrict__ words, long long n_words) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long w = warp; w < n_words; w += n_warps) {  // warp-uniform loop
    const unsigned bits = __ballot_sync(0xffffffffu, flags[w * 32 + lane] != 0);
    if (lane == 0) words[w] = bits;
  }
}

__device__ __forceinline__ uint4 bit_or(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t bit_or(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 shfl_xor(uint4 v, int m) {
  return make_uint4(__shfl_xor_sync(0xffffffffu, v.x, m), __shfl_xor_sync(0xffffffffu, v.y, m),
                    __shfl_xor_sync(0xffffffffu, v.z, m), __shfl_xor_sync(0xffffffffu, v.w, m));
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// V: uint4 (4 words) or uint32_t; n_vec: V's a row. Block b ORs column tile
// b, vectors [b kOrCols, (b + 1) kOrCols), over every row.
template <typename V>
__global__ void __launch_bounds__(kOrThreads)
or_rows_kernel(const V* __restrict__ words, V* __restrict__ out, long long rows, long long n_vec) {
  constexpr int kWarps = kOrThreads / 32;
  __shared__ V part[kWarps][kOrCols];
  const int col = threadIdx.x % kOrCols;
  const int lane = threadIdx.x / kOrCols;
  const int warp = threadIdx.x / 32;
  const long long v = static_cast<long long>(blockIdx.x) * kOrCols + col;
  V acc{};
  if (v < n_vec) {
    for (long long r0 = lane; r0 < rows; r0 += static_cast<long long>(kOrLanes) * kOrInFlight) {
      V x[kOrInFlight];
#pragma unroll
      for (int k = 0; k < kOrInFlight; ++k) {
        const long long r = r0 + static_cast<long long>(k) * kOrLanes;
        x[k] = r < rows ? words[r * n_vec + v] : V{};
      }
#pragma unroll
      for (int k = 0; k < kOrInFlight; ++k) acc = bit_or(acc, x[k]);
    }
  }
#pragma unroll
  for (int m = kOrCols; m < 32; m *= 2) acc = bit_or(acc, shfl_xor(acc, m));  // the warp's lanes
  if ((threadIdx.x & 31) < kOrCols) part[warp][col] = acc;
  __syncthreads();
  if (warp == 0) {  // thread t: column t % kOrCols of warps t / kOrCols, + 32 / kOrCols, ...
    V all{};
#pragma unroll
    for (int w = threadIdx.x / kOrCols; w < kWarps; w += 32 / kOrCols)
      all = bit_or(all, part[w][col]);
#pragma unroll
    for (int m = kOrCols; m < 32; m *= 2) all = bit_or(all, shfl_xor(all, m));
    if (threadIdx.x < kOrCols && v < n_vec) out[v] = all;
  }
}

__global__ void __launch_bounds__(kPopThreads)
popcount_rows_kernel(const uint32_t* __restrict__ words, unsigned long long* out, long long rows,
                     long long n_words) {
  __shared__ unsigned long long warp_sums[kPopThreads / 32];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* wr = words + row * n_words;
    unsigned long long sum = 0;
#pragma unroll 8
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < n_words; i += static_cast<long long>(gridDim.x) * blockDim.x)
      sum += __popc(wr[i]);
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
      for (int k = 0; k < kPopThreads / 32; ++k) total += warp_sums[k];
      if (gridDim.x == 1)
        out[row] = total;  // the row's one strip: no prefill needed
      else if (total)
        atomicAdd(out + row, total);
    }
    __syncthreads();  // warp_sums is reused by the next row
  }
}

unsigned blocks_for(long long items, long long per_block) {
  long long b = (items + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 on success). The
// caller checks arguments: contiguous tensors, n_words >= 1 (popcount: >=
// 0), rows >= 1 (OR: >= 0).

// flags: n_words * 32 flags of flag_bytes (1 or 4) bytes each -> n_words u32.
extern "C" int bitmap_pack(const void* flags, int flag_bytes, void* words, long long n_words,
                           void* stream) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (flag_bytes != 1 && flag_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* out = static_cast<uint32_t*>(words);
  if (reinterpret_cast<uintptr_t>(flags) % 16 == 0) {
    const long long n_vec = n_words * 2 * flag_bytes;  // 32 flags = 2 or 8 vectors
    unsigned grid = blocks_for(n_vec, static_cast<long long>(kThreads) * kVecUnroll);
    const unsigned cap = static_cast<unsigned>(sm_count) * kPackBlocksPerSm;
    if (grid > cap) grid = cap;
    if (flag_bytes == 1)
      pack_kernel<1><<<grid, kThreads, 0, st>>>(static_cast<const uint4*>(flags), out, n_vec);
    else
      pack_kernel<4><<<grid, kThreads, 0, st>>>(static_cast<const uint4*>(flags), out, n_vec);
  } else {
    const unsigned grid = blocks_for(n_words, kThreads / 32);
    if (flag_bytes == 1)
      pack_kernel_unaligned<uint8_t><<<grid, kThreads, 0, st>>>(
          static_cast<const uint8_t*>(flags), out, n_words);
    else
      pack_kernel_unaligned<uint32_t><<<grid, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(flags), out, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// words (rows, n_words) -> out (n_words,) = the OR of every row (0 for no
// rows), one launch; out needs no fill. 16-byte vectors where both bases
// are 16-byte aligned and n_words % 4 == 0, else single words.
extern "C" int bitmap_or_rows(const void* words, void* out, long long rows, long long n_words,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(words) | reinterpret_cast<uintptr_t>(out)) &
                    15) == 0 && n_words % 4 == 0;
  const long long n_vec = vec ? n_words / 4 : n_words;
  const long long tiles = (n_vec + kOrCols - 1) / kOrCols;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    or_rows_kernel<uint4><<<static_cast<unsigned>(tiles), kOrThreads, 0, st>>>(
        static_cast<const uint4*>(words), static_cast<uint4*>(out), rows, n_vec);
  else
    or_rows_kernel<uint32_t><<<static_cast<unsigned>(tiles), kOrThreads, 0, st>>>(
        static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), rows, n_vec);
  return static_cast<int>(cudaGetLastError());
}

// words (rows, n_words) -> out (rows,) u64 = set bits of each row, in
// strips of kStripWords words; out is zeroed here only when a row has
// more than one strip (their atomics add into it), else stored directly.
extern "C" int bitmap_popcount_rows(const void* words, void* out, long long rows,
                                    long long n_words, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned gx = blocks_for(n_words, kStripWords);
  if (gx > kStripBlocks) gx = kStripBlocks;
  if (gx > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, rows * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(gx, blocks_for(rows, 1));
  popcount_rows_kernel<<<grid, kPopThreads, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<unsigned long long*>(out), rows, n_words);
  return static_cast<int>(cudaGetLastError());
}
