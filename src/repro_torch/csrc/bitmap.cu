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
// - OR across rows: a thread ORs a strip of rows of one word column in
//   registers and ends with one atomicOr into the zeroed output. OR is
//   associative and commutative, so the result does not depend on the
//   order the atomics land in.
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
// written), 4 B per word read for OR and popcount (plus 8 B per row count
// written). At 512 words the popcount's bound is 6e-7 ms at the H100
// SXM's data-sheet 3.35 TB/s, far under a launch: what a call costs is its
// launch path, so the design spends one launch and nothing else on it. The
// same holds for the replay's single-row pack (16,384 flags): its C entry
// reads the SM count once and caches it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOrRows = 32;          // rows one thread ORs before its atomic
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

__global__ void or_rows_kernel(const uint32_t* __restrict__ words, uint32_t* out,
                               long long rows, long long n_words) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n_words) return;
  for (long long r0 = static_cast<long long>(blockIdx.y) * kOrRows; r0 < rows;
       r0 += static_cast<long long>(gridDim.y) * kOrRows) {
    const long long r1 = r0 + kOrRows < rows ? r0 + kOrRows : rows;
    uint32_t acc = 0;
    for (long long r = r0; r < r1; ++r) acc |= words[r * n_words + c];
    if (acc) atomicOr(out + c, acc);
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
// 0), rows >= 1, and a zeroed output for OR.

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

// words (rows, n_words) -> out (n_words,) |= every row.
extern "C" int bitmap_or_rows(const void* words, void* out, long long rows, long long n_words,
                              void* stream) {
  const dim3 grid(blocks_for(n_words, kThreads), blocks_for(rows, kOrRows));
  or_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), rows, n_words);
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
