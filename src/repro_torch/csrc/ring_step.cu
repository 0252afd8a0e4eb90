// One step of the ring allgather for every rank of a stacked buffer.
//
// Hopper counterpart of `ring_allgather_tpu` (src/repro/kernels/ring_allgather.py:46).
// On the TPU each device remote-DMAs one shard to its ring neighbour per grid
// step. Here the P ranks are dim 1 of one buffer on one card,
//
//     buf (G, P_rank, P_slot, n),  rank d holds shard j in slot j,
//
// and one launch does one step for all G*P ranks at once:
//
//     buf[g, (d + dir) % P, src] <- buf[g, d, src],  src = (d - dir * step) % P
//
// which is `ring_schedule` (ring_allgather.py:111) for dir = +1. Elements
// [0, split) of a slot move along `dir` and [split, n) along `-dir`, so the
// bidirectional gather does both half-buffers in one launch. With
// `rounds` > 1 only slots with src % rounds == active_round move: the
// `active` predicate of bcast_allgather_local (core/collectives.py:145).
//
// Within one step no slot region is both read and written (rank d + dir
// reads slot src + dir this step, never src), so blocks need no ordering.
//
// Bound: HBM bytes, 2 * P * n * itemsize per step (each moving slot read once
// and written once); there is no arithmetic. The design copies 16-byte
// vectors with a grid-stride loop so that every warp issues full 512-byte
// transactions, and a scalar head and tail cover spans that do not start on
// or fill a 16-byte boundary. The copy is bitwise, so the element type only
// sets the carrier width (2 or 4 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1024;

__device__ __forceinline__ int wrap(int x, int p) { return ((x % p) + p) % p; }

template <typename T>
__global__ void ring_step_kernel(T* buf, int p, long long n, int step, int dir,
                                 long long split, int rounds, int active_round) {
  const long long row = blockIdx.y;  // g * P + d
  const int d = static_cast<int>(row % p);
  const long long g = row / p;
  const int part = blockIdx.z;  // 0: [0, split) along dir; 1: [split, n) along -dir
  const int pdir = part == 0 ? dir : -dir;
  const int src = wrap(d - pdir * step, p);
  if (src % rounds != active_round) return;
  const int dst = wrap(d + pdir, p);
  const long long lo = part == 0 ? 0 : split;
  const long long len = part == 0 ? split : n - split;

  const T* s = buf + ((g * p + d) * p + src) * n + lo;
  T* o = buf + ((g * p + dst) * p + src) * n + lo;

  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
  long long head = len;  // scalar elements before the first 16-byte vector
  long long nvec = 0;
  if ((sa & 15) == (oa & 15)) {
    head = static_cast<long long>(((16 - (sa & 15)) & 15) / sizeof(T));
    if (head > len) head = len;
    nvec = (len - head) / kVec;
  }
  const long long tail = head + nvec * kVec;

  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  for (long long i = tid; i < nvec; i += stride) ov[i] = sv[i];
  for (long long i = tid; i < head; i += stride) o[i] = s[i];
  for (long long i = tail + tid; i < len; i += stride) o[i] = s[i];
}

template <typename T>
cudaError_t launch(void* buf, long long groups, int p, long long n, int step, int dir,
                   long long split, int rounds, int active_round, cudaStream_t stream) {
  const long long span = split > n - split ? split : n - split;
  const long long vecs = (span * static_cast<long long>(sizeof(T)) + 15) / 16;
  long long bx = (vecs + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(groups * p),
                  split < n ? 2u : 1u);
  ring_step_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<T*>(buf), p, n, step, dir,
                                                     split, rounds, active_round);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks arguments: dtype 0 (f32), 1 (bf16) or 2 (f16), groups * p <= 65535,
// 0 <= step < p, dir = +-1, 0 < split <= n, p % rounds == 0,
// 0 <= active_round < rounds.
extern "C" int ring_step(void* buf, int dtype, long long groups, int p, long long n,
                         int step, int dir, long long split, int rounds, int active_round,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    err = launch<uint16_t>(buf, groups, p, n, step, dir, split, rounds, active_round, st);
  else if (dtype == 0)
    err = launch<uint32_t>(buf, groups, p, n, step, dir, split, rounds, active_round, st);
  return static_cast<int>(err);
}
