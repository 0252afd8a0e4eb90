// The transpose of one ring-allgather step for every rank of a stacked buffer.
//
// Adjoint of one ring step (`ring_step`: one entry of ring_allgather.cu),
// the Hopper counterpart of `ring_allgather_tpu`
// (src/repro/kernels/ring_allgather.py:46). The forward step copies, for
// every rank d,
//
//     buf[g, (d + dir) % P, src] <- buf[g, d, src],  src = (d - dir * step) % P
//
// so its adjoint on a cotangent buffer g (G, P_rank, P_slot, n) adds the
// receiver's slot into the sender's over the same triples and masks:
//
//     g[g, d, src] += g[g, (d + dir) % P, src]
//
// Elements [0, split) use `dir` and [split, n) use `-dir` (the bidirectional
// gather); with `rounds` > 1 only slots with src % rounds == active_round
// move (the broadcast composition's round mask). Replayed in reverse step
// order this sums each slot along its chain from the far end, the nesting
// JAX's transpose of the ppermute ring produces (core/collectives.py:79).
//
// Within one step no slot region is both read and written (rank d writes
// slot src and rank d + dir's slot src is read; rank d + dir writes slot
// src + dir), so blocks need no ordering. The adds are done in f32 and
// rounded once to the element type, as torch adds bf16 and f16 tensors.
//
// Bound: HBM bytes, 3 * P * n * itemsize per step (two slots read, one
// written per rank). 16-byte vectors in a grid-stride loop over one rank's
// slot per block row, with a scalar head and tail for
// spans off a 16-byte boundary.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1024;

__device__ __forceinline__ int wrap(int x, int p) { return ((x % p) + p) % p; }

// Element types by their carrier: the kernel moves raw bits and converts
// only to add.
struct F32 {
  using C = uint32_t;
  static __device__ __forceinline__ C add(C a, C b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};
struct BF16 {
  using C = uint16_t;
  static __device__ __forceinline__ C add(C a, C b) {
    const float s = __bfloat162float(__ushort_as_bfloat16(a)) +
                    __bfloat162float(__ushort_as_bfloat16(b));
    return __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
};
struct F16 {
  using C = uint16_t;
  static __device__ __forceinline__ C add(C a, C b) {
    const float s = __half2float(__ushort_as_half(a)) + __half2float(__ushort_as_half(b));
    return __half_as_ushort(__float2half_rn(s));
  }
};

template <typename E>
__global__ void ring_step_transpose_kernel(typename E::C* buf, int p, long long n, int step,
                                           int dir, long long split, int rounds,
                                           int active_round) {
  using C = typename E::C;
  const long long row = blockIdx.y;  // g * P + d
  const int d = static_cast<int>(row % p);
  const long long g = row / p;
  const int part = blockIdx.z;  // 0: [0, split) along dir; 1: [split, n) along -dir
  const int pdir = part == 0 ? dir : -dir;
  const int src = wrap(d - pdir * step, p);
  if (src % rounds != active_round) return;
  const int rcv = wrap(d + pdir, p);
  const long long lo = part == 0 ? 0 : split;
  const long long len = part == 0 ? split : n - split;

  const C* s = buf + ((g * p + rcv) * p + src) * n + lo;  // the receiver's cotangent
  C* o = buf + ((g * p + d) * p + src) * n + lo;          // accumulates into the sender's

  constexpr int kVec = 16 / sizeof(C);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
  long long head = len;  // scalar elements before the first 16-byte vector
  long long nvec = 0;
  if ((sa & 15) == (oa & 15)) {
    head = static_cast<long long>(((16 - (sa & 15)) & 15) / sizeof(C));
    if (head > len) head = len;
    nvec = (len - head) / kVec;
  }
  const long long tail = head + nvec * kVec;

  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  for (long long i = tid; i < nvec; i += stride) {
    uint4 a = ov[i];
    const uint4 b = sv[i];
    C* ae = reinterpret_cast<C*>(&a);
    const C* be = reinterpret_cast<const C*>(&b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ae[j] = E::add(ae[j], be[j]);
    ov[i] = a;
  }
  for (long long i = tid; i < head; i += stride) o[i] = E::add(o[i], s[i]);
  for (long long i = tail + tid; i < len; i += stride) o[i] = E::add(o[i], s[i]);
}

template <typename E>
cudaError_t launch(void* buf, long long groups, int p, long long n, int step, int dir,
                   long long split, int rounds, int active_round, cudaStream_t stream) {
  using C = typename E::C;
  const long long span = split > n - split ? split : n - split;
  const long long vecs = (span * static_cast<long long>(sizeof(C)) + 15) / 16;
  long long bx = (vecs + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(groups * p),
                  split < n ? 2u : 1u);
  ring_step_transpose_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<C*>(buf), p, n, step, dir, split, rounds, active_round);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks arguments: dtype 0 (f32), 1 (bf16) or 2 (f16), groups * p <= 65535,
// 0 <= step < p, dir = +-1, 0 < split <= n, p % rounds == 0,
// 0 <= active_round < rounds.
extern "C" int ring_step_transpose(void* buf, int dtype, long long groups, int p,
                                   long long n, int step, int dir, long long split,
                                   int rounds, int active_round, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch<F32>(buf, groups, p, n, step, dir, split, rounds, active_round, st);
  else if (dtype == 1)
    err = launch<BF16>(buf, groups, p, n, step, dir, split, rounds, active_round, st);
  else if (dtype == 2)
    err = launch<F16>(buf, groups, p, n, step, dir, split, rounds, active_round, st);
  return static_cast<int>(err);
}
