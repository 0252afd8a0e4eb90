// The transpose of a whole ring-allgather schedule in one launch: the
// gathers' backward and the ring reduce-scatters.
//
// Adjoint of `ring_allgather` (ring_allgather.cu), the Hopper counterpart of
// `ring_allgather_tpu` (src/repro/kernels/ring_allgather.py:46); the TPU has
// no kernel of its own for it (JAX transposes the ppermute ring). Entry k of
// a schedule is one ring step (step, dir, split, rounds, active_round) for
// every rank, and its adjoint on a cotangent g (G, P_rank, P_slot, n) adds
// the receiver's slot into the sender's over the same triples and masks
// (`ring_step_transpose_plain`, kernels/ring_allgather.py):
//
//     g[g, d, src] += g[g, (d + dir) % P, src],  src = (d - dir * step) % P
//
// for elements [0, split) of a slot, the mirror along -dir for [split, n),
// and with `rounds` > 1 only the slots with src % rounds == active_round.
// Run over the schedule's entries in reverse order and read on the diagonal,
// out[g, d] = g[g, d, d], this is the backward of the gather: rank d's
// gradient is the sum of every rank's cotangent of shard d, summed along the
// chain from its far end as JAX's transpose of the ring sums it
// (src/repro/core/collectives.py:79). The host passes the entries in the
// order the kernel runs them, the schedule's reverse.
//
// Design: ring_allgather.cu's, mirrored. A column (a 16-byte vector of every
// slot where g, out, n and every split allow it, else one element) belongs to
// W lanes of one warp, W the power of two at or above P (P <= 32), lane d
// holding rank d. At a reversed entry lane d's new partial sum is
// add(g[d, src], the neighbour's value of slot src), and rank d + dir's slot
// src is the one that rank d + dir summed at the entry before when that entry
// continues this one's ring or round (`chained`: the same direction, split
// and round mask, one step further). So lane d takes it from lane d + dir's
// registers by a warp shuffle: the partial sums travel against the ring, and
// only the first entry of each ring or round loads the neighbour's slot.
// Lane d keeps the sum it writes to its own diagonal slot and stores it in
// `out` at the end (g's diagonal where no entry wrote it).
//
// Two modes, chosen by the host for each schedule:
// - reads only (store = 0): g is never written. The host has checked that
//   no entry reads a slot that an earlier entry wrote, other than through the
//   shuffle. The ring, the bidirectional ring and the composition of
//   broadcasts pass, and any prefix of one: each rank writes each slot at
//   most once, and reads its own slot only there. g is then read-only, so
//   the loads of kAhead entries are issued before their adds.
// - in place (store = 1): every entry stores its sums into g, a scratch copy
//   the host made, and ends with a `__syncwarp()` that orders its stores
//   before the next entry's loads within the warp, as ring_allgather.cu does.
//   For the schedules the check refuses (entries of mixed kinds in no
//   schedule's order), for more entries than one launch carries (one launch
//   per kMaxEntries, in order on one stream; only the last writes `out`), and
//   for P > 32: one thread per column runs every rank's adds, kBatch slots
//   loaded before any is stored (within one entry no slot is both read and
//   written: rank d writes slot src of its own row, reads rank d + dir's).
//
// Exactness: every add is done in f32 and rounded once to the element type
// (the F32 / BF16 / F16 structs below), in the nesting of
// the step-by-step replay, so the result equals the plain replay bitwise.
//
// Bound: HBM bytes. In reads-only mode, on those schedules, each slot of g is
// read once and each of the result's P slots written once per group:
// (P * P + P) * n * itemsize bytes. What is left is latency: per entry a
// shuffle and an add per lane, in sequence along the chain.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxEntries = 128;  // the schedule travels in the kernel's parameters
constexpr int kMaxLanes = 32;     // ranks of one column in one warp
constexpr int kAhead = 4;         // reads only: entries loaded before their adds
constexpr int kBatch = 8;         // P > 32: slots loaded before any is stored

struct Entry {
  int step, dir, rounds, active;
  long long split;
};

struct Schedule {
  int count;
  Entry e[kMaxEntries];
};

// Element types by their carrier: the kernel moves raw bits and converts
// only to add, rounding once per add as torch adds bf16 and f16 tensors.
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

// x in (-p, 2p) -> x mod p, without a division.
__device__ __forceinline__ int wrap(int x, int p) { return x < 0 ? x + p : x >= p ? x - p : x; }

// Whether rank d's slot takes part in this step, and which slot (src).
__device__ __forceinline__ bool moves(int d, int p, int step, int dir, int rounds, int active,
                                      int* src) {
  *src = wrap(d - dir * step, p);
  return rounds == 1 || *src % rounds == active;
}

// Whether e, run after prev, continues prev's ring or round one step back.
__device__ __forceinline__ bool continues(const Entry& prev, const Entry& e) {
  return prev.dir == e.dir && prev.split == e.split && prev.rounds == e.rounds &&
         prev.active == e.active && prev.step == e.step + 1;
}

// The entries, staged in shared memory with whether each continues the one
// before.
__device__ __forceinline__ void stage(const Schedule& s, Entry* entries, bool* chained) {
  for (int k = threadIdx.x; k < s.count; k += kThreads) {
    entries[k] = s.e[k];
    chained[k] = k > 0 && continues(s.e[k - 1], s.e[k]);
  }
  __syncthreads();
}

__device__ __forceinline__ uint4 shfl(uint4 x, int lane, int width) {
  return make_uint4(__shfl_sync(0xffffffffu, x.x, lane, width),
                    __shfl_sync(0xffffffffu, x.y, lane, width),
                    __shfl_sync(0xffffffffu, x.z, lane, width),
                    __shfl_sync(0xffffffffu, x.w, lane, width));
}
template <typename T>
__device__ __forceinline__ T shfl(T x, int lane, int width) {
  return static_cast<T>(__shfl_sync(0xffffffffu, static_cast<uint32_t>(x), lane, width));
}

template <typename V>
__device__ __forceinline__ V load(const char* p) {
  return *reinterpret_cast<const V*>(p);
}
template <typename V>
__device__ __forceinline__ void store(char* p, V v) {
  *reinterpret_cast<V*>(p) = v;
}

// Element by element, a + b in E's arithmetic.
template <typename E, typename V>
__device__ __forceinline__ V add(V a, V b) {
  using C = typename E::C;
  constexpr int kVec = sizeof(V) / sizeof(C);
  C* ae = reinterpret_cast<C*>(&a);
  const C* be = reinterpret_cast<const C*>(&b);
#pragma unroll
  for (int j = 0; j < kVec; ++j) ae[j] = E::add(ae[j], be[j]);
  return a;
}

// P <= 32: a column's ranks on the lanes of one warp. kStore: in place.
template <typename E, typename V, bool kStore>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_transpose_kernel(typename E::C* g, typename E::C* out, int p, int width,
                                    long long n, const __grid_constant__ Schedule s) {
  using C = typename E::C;
  __shared__ Entry entries[kMaxEntries];
  __shared__ bool chained[kMaxEntries];
  stage(s, entries, chained);
  constexpr int kVec = sizeof(V) / sizeof(C);
  constexpr int kRun = kStore ? 1 : kAhead;  // in place: each entry loads after the last stored
  const int d = threadIdx.x % width;
  const long long c =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / width * kVec;
  const bool live = d < p && c < n;  // the other lanes only shuffle
  const long long slot_bytes = n * static_cast<long long>(sizeof(C));
  char* base =
      reinterpret_cast<char*>(g) + static_cast<long long>(blockIdx.y) * p * p * slot_bytes;
  const long long col = c * static_cast<long long>(sizeof(C));
  V held{};  // the sum rank d wrote at the previous entry
  V diag{};  // the sum rank d wrote to its own diagonal slot
  bool diag_set = false;
  for (int k0 = 0; k0 < s.count; k0 += kRun) {
    V own[kRun], nb[kRun];
    int src[kRun];
    bool mv[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {  // the loads
      const int k = k0 + j;
      mv[j] = false;
      if (live && k < s.count) {
        const Entry en = entries[k];
        const int dir = c < en.split ? en.dir : -en.dir;
        mv[j] = moves(d, p, en.step, dir, en.rounds, en.active, &src[j]);
        if (mv[j]) {
          own[j] = load<V>(base + (d * p + src[j]) * slot_bytes + col);
          if (!chained[k]) nb[j] = load<V>(base + (wrap(d + dir, p) * p + src[j]) * slot_bytes + col);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {  // the adds, in order along the chain
      const int k = k0 + j;
      if (k >= s.count) break;  // the same on every lane
      const Entry en = entries[k];
      const int dir = c < en.split ? en.dir : -en.dir;
      const V from_next = shfl(held, wrap(d + dir, p), width);
      if (mv[j]) {
        const V v = add<E>(own[j], chained[k] ? from_next : nb[j]);
        if (kStore) store(base + (d * p + src[j]) * slot_bytes + col, v);
        held = v;
        if (src[j] == d) {
          diag = v;
          diag_set = true;
        }
      }
      if (kStore) __syncwarp();
    }
  }
  if (out != nullptr && live) {
    if (!diag_set) diag = load<V>(base + (d * p + d) * slot_bytes + col);
    store(reinterpret_cast<char*>(out) + (static_cast<long long>(blockIdx.y) * p + d) * slot_bytes +
              col,
          diag);
  }
}

// P > 32, in place: one thread per column runs every rank's adds, kBatch
// slots loaded before any is stored, then reads the diagonal into out.
template <typename E, typename V>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_transpose_wide_kernel(typename E::C* g, typename E::C* out, int p,
                                         long long n, const __grid_constant__ Schedule s) {
  using C = typename E::C;
  __shared__ Entry entries[kMaxEntries];
  __shared__ bool chained[kMaxEntries];
  stage(s, entries, chained);
  constexpr int kVec = sizeof(V) / sizeof(C);
  const long long c = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const long long slot_bytes = n * static_cast<long long>(sizeof(C));
  char* base =
      reinterpret_cast<char*>(g) + static_cast<long long>(blockIdx.y) * p * p * slot_bytes;
  const long long col = c * static_cast<long long>(sizeof(C));
  for (int k = 0; k < s.count; ++k) {
    const Entry en = entries[k];
    const int dir = c < en.split ? en.dir : -en.dir;
    for (int d0 = 0; d0 < p; d0 += kBatch) {
      V v[kBatch];
      long long dst[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int d = d0 + j;
        int src;
        dst[j] = -1;
        if (d < p && moves(d, p, en.step, dir, en.rounds, en.active, &src)) {
          dst[j] = (d * p + src) * slot_bytes + col;
          v[j] = add<E>(load<V>(base + dst[j]),
                        load<V>(base + (wrap(d + dir, p) * p + src) * slot_bytes + col));
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (dst[j] >= 0) store(base + dst[j], v[j]);
    }
  }
  if (out != nullptr) {
    char* o = reinterpret_cast<char*>(out) + static_cast<long long>(blockIdx.y) * p * slot_bytes;
    for (int d = 0; d < p; ++d)
      store(o + d * slot_bytes + col, load<V>(base + (d * p + d) * slot_bytes + col));
  }
}

template <typename E, typename V>
void launch_kernel(void* g, void* out, long long groups, int p, long long n, const Schedule& s,
                   bool in_place, cudaStream_t stream) {
  using C = typename E::C;
  const long long columns = (n + sizeof(V) / sizeof(C) - 1) / (sizeof(V) / sizeof(C));
  C* gc = static_cast<C*>(g);
  C* oc = static_cast<C*>(out);
  if (p <= kMaxLanes) {
    int width = 1;
    while (width < p) width *= 2;
    const long long threads = columns * width;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                    static_cast<unsigned>(groups));
    if (in_place)
      ring_allgather_transpose_kernel<E, V, true><<<grid, kThreads, 0, stream>>>(gc, oc, p, width,
                                                                                 n, s);
    else
      ring_allgather_transpose_kernel<E, V, false><<<grid, kThreads, 0, stream>>>(gc, oc, p,
                                                                                  width, n, s);
  } else {
    const dim3 grid(static_cast<unsigned>((columns + kThreads - 1) / kThreads),
                    static_cast<unsigned>(groups));
    ring_allgather_transpose_wide_kernel<E, V><<<grid, kThreads, 0, stream>>>(gc, oc, p, n, s);
  }
}

template <typename E>
cudaError_t launch(void* g, void* out, long long groups, int p, long long n, const Schedule& s,
                   bool in_place, cudaStream_t stream) {
  constexpr long long kVec = 16 / sizeof(typename E::C);
  bool vec = ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
             n % kVec == 0;
  for (int k = 0; k < s.count; ++k) vec = vec && s.e[k].split % kVec == 0;  // no vector cut
  if (vec)
    launch_kernel<E, uint4>(g, out, groups, p, n, s, in_place, stream);
  else
    launch_kernel<E, typename E::C>(g, out, groups, p, n, s, in_place, stream);
  return cudaGetLastError();
}

}  // namespace

// Runs `count` entries on the cotangent g (G, P, P, n), in the order given
// (the schedule's reverse), in one launch, and writes the diagonal's sums to
// out (G, P, n) unless out is null. in_place 0: g is only read (P <= 32, and
// the caller has checked the entries, see above); 1: the sums are stored
// into g. `entries` is host memory, five values per entry: step, dir,
// split, rounds, active_round. Returns cudaGetLastError() after the launch
// (0 on success). The caller checks arguments: dtype 0 (f32), 1 (bf16) or 2
// (f16), groups <= 65535, 0 <= count <= 128, and per entry
// 0 <= step < p - 1, dir = +-1, 0 <= split <= n, p % rounds == 0,
// 0 <= active_round < rounds.
extern "C" int ring_allgather_transpose(void* g, void* out, int dtype, long long groups, int p,
                                        long long n, const long long* entries, int count,
                                        int in_place, void* stream) {
  if (count < 0 || count > kMaxEntries || (!in_place && p > kMaxLanes))
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule s;
  s.count = count;
  for (int k = 0; k < count; ++k) {
    const long long* e = entries + 5 * k;
    s.e[k] = Entry{static_cast<int>(e[0]), static_cast<int>(e[1]), static_cast<int>(e[3]),
                   static_cast<int>(e[4]), e[2]};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch<F32>(g, out, groups, p, n, s, in_place != 0, st);
  else if (dtype == 1)
    err = launch<BF16>(g, out, groups, p, n, s, in_place != 0, st);
  else if (dtype == 2)
    err = launch<F16>(g, out, groups, p, n, s, in_place != 0, st);
  return static_cast<int>(err);
}
