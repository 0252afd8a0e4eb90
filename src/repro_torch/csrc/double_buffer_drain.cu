// The receive datapath's two-slot staging ring, drained step by step.
//
// Hopper counterpart of `local_double_buffer_drain`
// (src/repro/kernels/ring_allgather.py:94), the Pallas kernel whose grid
// step s drains slot s % 2 of the staging ring into out[s]: the local-copy
// half of the ring engine, in which a chunk lands in one slot while the
// other drains (the staging discipline of the paper's §III-B at two-slot
// depth). What it computes is an identity copy of
//
//     staged (n_steps, step_bytes) -> out (n_steps, step_bytes),
//
// bitwise, for any element type. On the TPU the grid runs the steps in
// order on one core; here the steps are blockIdx.y and every step's bytes
// are split over a row of blocks that run in parallel. The two-slot
// discipline moves inside each block: a block streams its 4 KB tiles of one
// step through two shared-memory slots with 16-byte `cp.async` copies, so
// that tile t + 1 lands in one slot while tile t drains from the other to
// device memory (`cp.async.wait_group 1`: all but the newest group have
// landed). Every thread drains the 16 bytes it copied itself, so a slot
// needs no barrier between its threads; the copy of tile t + 2 into the slot
// that tile t drained from is issued by the same thread after its drain
// (the "memory" clobbers keep the compiler from moving it earlier).
//
// A step's span need not start on a 16-byte boundary (a view into a larger
// buffer) nor fill whole vectors: the bytes before the source's first
// 16-byte boundary (the head) and after its last (the tail) are copied one
// by one. Where the output's offset from a 16-byte boundary differs from
// the source's, the drained vectors are stored byte by byte.
//
// Bound: HBM bytes, 2 * n_steps * step_bytes (each byte read once and
// written once); there is no arithmetic. Two 4 KB slots per block of 256
// threads and up to 8 blocks per SM keep 64 KB per SM in flight, enough to
// cover device-memory latency at the card's rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a tile: one 16-byte vector a thread, 4 KB
constexpr long long kBlocks = 132 * 8; // blocks in flight on the card, over all steps

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
drain_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long step_bytes) {
  __shared__ __align__(16) uint4 slot[2][kThreads];
  const long long step = blockIdx.y;
  const uint8_t* s = src + step * step_bytes;
  uint8_t* o = dst + step * step_bytes;
  const int tid = threadIdx.x;

  // head and tail: the bytes outside the source's 16-byte vectors
  long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15);
  if (head > step_bytes) head = step_bytes;
  const long long nvec = (step_bytes - head) / 16;
  const long long tail = head + nvec * 16;
  if (blockIdx.x == 0) {
    for (long long i = tid; i < head; i += kThreads) o[i] = s[i];
    for (long long i = tail + tid; i < step_bytes; i += kThreads) o[i] = s[i];
  }

  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint8_t* ov = o + head;
  const bool aligned = (reinterpret_cast<uintptr_t>(ov) & 15) == 0;
  const long long n_tiles = (nvec + kThreads - 1) / kThreads;
  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  auto load = [&](long long tile, int k) {
    const long long v = tile * kThreads + tid;
    if (tile < n_tiles && v < nvec) cp_async16(&slot[k][tid], sv + v);
    cp_async_commit();  // an empty group past the end keeps the count even
  };
  long long tile = blockIdx.x;
  load(tile, 0);
  for (int k = 0; tile < n_tiles; tile += gridDim.x, k ^= 1) {
    load(tile + gridDim.x, k ^ 1);  // tile t + 1 lands in the other slot ...
    cp_async_wait_prev();           // ... while tile t, landed, drains
    const long long v = tile * kThreads + tid;
    if (v < nvec) {
      if (aligned) {
        reinterpret_cast<uint4*>(ov)[v] = slot[k][tid];
      } else {
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&slot[k][tid]);
#pragma unroll
        for (int e = 0; e < 16; ++e) ov[v * 16 + e] = b[e];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks arguments: 1 <= n_steps <= 65535, step_bytes >= 1, and two
// contiguous buffers of n_steps * step_bytes bytes that do not overlap.
extern "C" int double_buffer_drain(const void* src, void* dst, long long n_steps,
                                   long long step_bytes, void* stream) {
  if (n_steps < 1 || n_steps > 65535 || step_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (step_bytes / 16 + kThreads - 1) / kThreads;
  long long bx = (kBlocks + n_steps - 1) / n_steps;
  if (bx > tiles) bx = tiles;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n_steps));
  drain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), step_bytes);
  return static_cast<int>(cudaGetLastError());
}
