// Staging-ring to user-buffer scatter of the receive datapath.
//
// Hopper counterpart of `chunk_reassembly` (src/repro/kernels/chunk_reassembly.py:41):
// for each staged chunk i < n_valid, user[psn[i]] = staging[i] and
// bitmap[psn[i]] = 1, the user buffer updated in place, a later duplicate
// PSN winning. The copy is bitwise, so any dtype is a row of `row_bytes`
// bytes; PSNs are int32 or int64, read in place (a template on the index
// type, no conversion launch).
//
// Bound: HBM bytes, 2 * row_bytes per valid staged chunk (read it, write
// it) plus its PSN and 4 B of bitmap per chunk: at broadcast A's shape
// (16,384 chunks of 4,096 B, int64 PSNs) 134,414,336 B, 0.0401 ms at the
// H100 SXM's data-sheet 3.35 TB/s. Nothing is reused, and the 128 MiB
// exceed the 50 MB L2.
//
// Design. One C call enqueues everything on the caller's stream and never
// synchronises with the host:
//
//   0. one cudaMemsetAsync zeroes the caller's scratch, bitmap (n_chunks
//      u32) then winner (n_chunks i32);
//   1. winner_kernel: winner[psn[i]] = max (i + 1) over the valid entries
//      (atomicMax; 0 means "none"). The Pallas grid runs i in order, so
//      "later wins" is free there; CUDA blocks run in no order, so the
//      order is settled here. A PSN outside [0, n_chunks) executes
//      __trap(): the launch fails and the fault surfaces as a CUDA error at
//      the caller's next synchronise. Nothing is written out of bounds and
//      no bad PSN passes silently (the host never reads the PSNs: that
//      would synchronise every call);
//   2. the scatter, flat over the valid rows' 16-byte vectors, a block per
//      tile of kVec * 256 vectors (four rows of 4,096 B): a thread first
//      issues kVec streaming loads (__ldcs) of staging, and only then reads
//      the PSN and its winner, which decide whether it stores (__stcs). The
//      loads do not wait on the two dependent reads, and kVec vectors a
//      thread stay in flight. It is launched as a programmatic dependent of
//      the winner pass: its first blocks start, and load, while that pass
//      runs, and wait for it (griddepcontrol.wait) only before the winner
//      reads. The row and column of a vector take one division. The thread
//      holding a winning row's first vector sets its bitmap word. Rows or
//      bases off a 16-byte boundary take a byte copy, a block per row.
//
// On the card (chip_smoke.py; PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W)
// one cudaMemcpyAsync of the same 64 MiB reaches 84 % of the bound, and a
// whole call here, zero fill and winner pass included, 78 %. A persistent
// grid, 8 or 16 vectors a thread, plain loads, a second tile in registers
// and TMA bulk copies of a row at a time were tried and were no faster.
// Offsets are 64-bit throughout: 32-bit ones, which buffers under 2^32
// vectors would allow, made a call 0.8 % faster at A's shape: too little
// to keep a second instantiation that no check could run, since only
// buffers of 32 GiB and more would take it.
//
// The rules are the reference's: the last duplicate wins, the bitmap is set
// only for valid entries, and n_valid = 0 leaves user as it was (only the
// zero fill runs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;               // 16-byte vectors in flight per thread
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ long long checked(long long d, long long n_chunks) {
  if (static_cast<unsigned long long>(d) >= static_cast<unsigned long long>(n_chunks)) __trap();
  return d;
}

template <typename Idx>
__global__ void winner_kernel(const Idx* __restrict__ psn, int32_t* __restrict__ winner,
                              long long n_valid, long long n_chunks) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");  // the scatter may start
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_valid; i += static_cast<long long>(gridDim.x) * blockDim.x)
    atomicMax(winner + checked(static_cast<long long>(psn[i]), n_chunks),
              static_cast<int32_t>(i + 1));
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
scatter_vec_kernel(const uint4* __restrict__ staging, const Idx* __restrict__ psn,
                   const int32_t* __restrict__ winner, uint4* __restrict__ user,
                   uint32_t* __restrict__ bitmap, long long n_vecs, long long row_vecs,
                   long long n_chunks) {
  const long long tile = static_cast<long long>(kVec) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * tile + threadIdx.x; base < n_vecs;
       base += static_cast<long long>(gridDim.x) * tile) {
    uint4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long e = base + static_cast<long long>(k) * kThreads;
      if (e < n_vecs) v[k] = __ldcs(staging + e);
    }
    // the winner pass complete and visible (returns at once after the first
    // time, and when the pass ended before this block started)
    asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long e = base + static_cast<long long>(k) * kThreads;
      if (e < n_vecs) {
        const long long i = e / row_vecs, c = e - i * row_vecs;
        const long long d = checked(static_cast<long long>(psn[i]), n_chunks);
        if (winner[d] == static_cast<int32_t>(i) + 1) {
          __stcs(user + d * row_vecs + c, v[k]);
          if (c == 0) bitmap[d] = 1u;
        }
      }
    }
  }
}

template <typename Idx>
__global__ void scatter_bytes_kernel(const uint8_t* __restrict__ staging,
                                     const Idx* __restrict__ psn,
                                     const int32_t* __restrict__ winner,
                                     uint8_t* __restrict__ user, uint32_t* __restrict__ bitmap,
                                     long long n_valid, long long row_bytes, long long n_chunks) {
  for (long long i = blockIdx.x; i < n_valid; i += gridDim.x) {  // block-uniform
    const long long d = checked(static_cast<long long>(psn[i]), n_chunks);
    if (winner[d] != i + 1) continue;
    const uint8_t* s = staging + i * row_bytes;
    uint8_t* o = user + d * row_bytes;
    for (long long k = threadIdx.x; k < row_bytes; k += blockDim.x) o[k] = s[k];
    if (threadIdx.x == 0) bitmap[d] = 1u;
  }
}

unsigned blocks_for(long long items, long long per_block) {
  long long b = (items + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b);
}

template <typename Idx>
cudaError_t scatter_vec(const void* staging, const Idx* psn, const int32_t* winner, void* user,
                        uint32_t* bitmap, long long n_vecs, long long row_vecs,
                        long long n_chunks, cudaStream_t st) {
  // programmatic dependent launch: the scatter's blocks start while the
  // winner pass runs, issue their loads, and wait for it before deciding
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(n_vecs, kVec * kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, scatter_vec_kernel<Idx>,
                            static_cast<const uint4*>(staging), psn, winner,
                            static_cast<uint4*>(user), bitmap, n_vecs, row_vecs, n_chunks);
}

template <typename Idx>
int run(const void* staging, const Idx* psn, int32_t* scratch, void* user, long long n_valid,
        long long n_chunks, long long row_bytes, cudaStream_t st) {
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(scratch);
  int32_t* winner = scratch + n_chunks;
  winner_kernel<Idx><<<blocks_for(n_valid, kThreads), kThreads, 0, st>>>(psn, winner, n_valid,
                                                                         n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(staging) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(user) % 16 == 0;
  if (vec16) {
    const long long row_vecs = row_bytes / 16;
    const long long n_vecs = n_valid * row_vecs;
    err = scatter_vec(staging, psn, winner, user, bitmap, n_vecs, row_vecs, n_chunks, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    scatter_bytes_kernel<Idx><<<blocks_for(n_valid, 1), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(staging), psn, winner, static_cast<uint8_t*>(user), bitmap,
        n_valid, row_bytes, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Zeroes scratch (2 * n_chunks 4-byte words: the bitmap, then the winners), then
// for n_valid >= 1 launches the winner pass and the scatter, all on
// `stream`. Returns the first CUDA error (0 on success). The caller checks
// arguments: staging (>= n_valid, row_bytes) and user (n_chunks, row_bytes)
// contiguous, psn (>= n_valid,) contiguous of psn_bytes 4 (int32) or 8
// (int64), 0 <= n_valid < 2^31, n_chunks < 2^31, row_bytes >= 1. The PSNs'
// range is checked on the device (above).
extern "C" int chunk_reassembly(const void* staging, const void* psn, int psn_bytes,
                                void* scratch, void* user, long long n_valid,
                                long long n_chunks, long long row_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (psn_bytes != 4 && psn_bytes != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * n_chunks * sizeof(int32_t), st);
  if (err != cudaSuccess || n_valid == 0) return static_cast<int>(err);
  int32_t* s = static_cast<int32_t*>(scratch);
  if (psn_bytes == 4)
    return run(staging, static_cast<const int32_t*>(psn), s, user, n_valid, n_chunks, row_bytes,
               st);
  return run(staging, static_cast<const int64_t*>(psn), s, user, n_valid, n_chunks, row_bytes,
             st);
}
