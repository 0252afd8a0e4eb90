// Staging-ring to user-buffer scatter of the receive datapath.
//
// Hopper counterpart of `chunk_reassembly` (src/repro/kernels/chunk_reassembly.py:41):
// for each staged chunk i < n_valid, user[psn[i]] = staging[i] and
// bitmap[psn[i]] = 1, the user buffer updated in place, a later duplicate
// PSN winning. The Pallas grid runs i in order, so "later wins" is free
// there; CUDA blocks run in no order and would race on a duplicate. So the
// scatter takes two kernels on one stream:
//
//   1. winner[psn[i]] = max i over the valid staged chunks (atomicMax into a
//      buffer the caller fills with -1);
//   2. one block per staged chunk: if it is its PSN's winner, it copies its
//      row to user[psn[i]] and sets bitmap[psn[i]] = 1; a loser does nothing.
//
// The copy is bitwise, so any dtype is a row of `row_bytes` bytes. When both
// buffers and the row length are 16-byte aligned it moves 16-byte vectors
// (a 4096-byte chunk is one vector per thread of a 256-thread block);
// otherwise it copies byte by byte.
//
// Bound: HBM bytes, 2 * row_bytes per valid staged chunk (read it, write
// it) plus 4 B of PSN and 4 B of bitmap; the winner pass reads the PSNs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void winner_kernel(const int32_t* __restrict__ psn, int32_t* winner,
                              long long n_valid) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_valid; i += static_cast<long long>(gridDim.x) * blockDim.x)
    atomicMax(winner + psn[i], static_cast<int32_t>(i));
}

__global__ void scatter_kernel(const uint8_t* __restrict__ staging,
                               const int32_t* __restrict__ psn,
                               const int32_t* __restrict__ winner, uint8_t* user,
                               uint32_t* bitmap, long long n_valid, long long row_bytes,
                               bool vec16) {
  for (long long i = blockIdx.x; i < n_valid; i += gridDim.x) {  // block-uniform
    const int32_t d = psn[i];
    if (winner[d] != i) continue;
    const uint8_t* s = staging + i * row_bytes;
    uint8_t* o = user + static_cast<long long>(d) * row_bytes;
    if (vec16) {
      const uint4* sv = reinterpret_cast<const uint4*>(s);
      uint4* ov = reinterpret_cast<uint4*>(o);
      for (long long k = threadIdx.x; k < row_bytes / 16; k += blockDim.x) ov[k] = sv[k];
    } else {
      for (long long k = threadIdx.x; k < row_bytes; k += blockDim.x) o[k] = s[k];
    }
    if (threadIdx.x == 0) bitmap[d] = 1u;
  }
}

unsigned blocks_for(long long items, long long per_block) {
  long long b = (items + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

}  // namespace

// Returns cudaGetLastError() after the two launches (0 on success). The
// caller checks arguments: staging (>= n_valid, row_bytes) and user
// (n_chunks, row_bytes) contiguous, psn int32 with 0 <= psn[i] < n_chunks
// for i < n_valid, winner (n_chunks,) int32 filled with -1, bitmap
// (n_chunks,) zeroed, 1 <= n_valid < 2^31, row_bytes >= 1.
extern "C" int chunk_reassembly(const void* staging, const void* psn, void* winner, void* user,
                                void* bitmap, long long n_valid, long long row_bytes,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  winner_kernel<<<blocks_for(n_valid, kThreads), kThreads, 0, st>>>(
      static_cast<const int32_t*>(psn), static_cast<int32_t*>(winner), n_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(staging) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(user) % 16 == 0;
  scatter_kernel<<<blocks_for(n_valid, 1), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(staging), static_cast<const int32_t*>(psn),
      static_cast<const int32_t*>(winner), static_cast<uint8_t*>(user),
      static_cast<uint32_t*>(bitmap), n_valid, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}
