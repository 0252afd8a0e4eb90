// A whole ring-allgather schedule, step by step, in one launch.
//
// Hopper counterpart of `ring_allgather_tpu` (src/repro/kernels/ring_allgather.py:46):
// one Pallas kernel over a sequential grid of P - 1 steps, in which device d
// remote-DMAs shard (d - s) % P to device d + 1 at step s and waits on a DMA
// semaphore before the next. Here the P ranks are dim 1 of one buffer on one
// card,
//
//     x (G, P_rank, n),  buf (G, P_rank, P_slot, n),
//
// (a group of P ranks may also lie at a stride: see Layout below, for the
// rings over a middle mesh axis of a stacked tensor, e.g. the dp ring of
// one tp group when ranks are numbered d * tp + m), and one launch first
// installs each rank's own shard in its own slot,
// buf[g, d, d] <- x[g, d] (the TPU kernel's `out_ref[my_id] = x_ref[...]`),
// then runs every entry of a schedule, in order. Entry k is one ring step
// for every rank at once:
//
//     buf[g, (d + dir) % P, src] <- buf[g, d, src],  src = (d - dir * step) % P
//
// for elements [0, split) of a slot, the mirror step along -dir for
// [split, n), and with `rounds` > 1 only the slots with
// src % rounds == active_round. The schedules are those of
// core/collectives.py: the ring (P - 1 entries), the bidirectional ring
// (P - 1 entries with split = n / 2) and the composition of broadcasts
// (P / M rounds of P - 1 masked entries), or any prefix of one. A slot that
// no entry reaches keeps what buf held. A schedule longer than the
// kMaxEntries that a launch's parameters carry runs as several launches in
// order on one stream; only the first installs (x null in the others). One
// entry with x null is one ring step in place (the wrapper's `ring_step`).
//
// Design. The TPU's sequential grid over steps becomes a loop over the
// entries inside the kernel. A step moves element j of a slot to element j
// of a slot of another rank, so no column of the buffer ever depends on
// another column. A column (a 16-byte vector of every slot where x and every
// slot start on a 16-byte boundary, else one element) belongs to one group of
// W lanes of one warp, W the power of two at or above P (P <= 32), lane d
// holding rank d: at each entry lane d moves rank d's slot of that column.
// Lane d installs rank d's shard of the column, then runs the entries.
// What rank d forwards at step s + 1 is what rank d - dir stored at step s,
// so where an entry continues the previous one (the next step of the same
// ring or round: `chained`) lane d takes it from lane d - dir's registers by
// a warp shuffle, and only the first entry of each ring or round loads from
// memory (at step 0 the slot that lane d itself installed). Every entry stores what it moves, in order, and ends with a
// `__syncwarp()`, which orders one entry's stores before the next entry's
// loads within the warp. So there is no barrier between blocks, no flag in
// memory, no wait on another block, and no block needs to be resident with
// any other. Within one entry no slot is both read and written (rank d + dir
// reads slot src + dir, never src). The bidi split and the round mask are
// taken per element and per slot; a vector that
// straddles the split moves element by element, from memory. P > 32 takes a
// plain loop: one thread per column runs every rank's moves, loading each
// entry's slots back from memory.
//
// Bound: HBM bytes. A whole gather reads every rank's shard once and writes
// every rank's gathered copy once, (P * P + P) * n * itemsize bytes per
// group; there is no arithmetic. A launch of the ring, bidi or broadcast
// schedule moves those bytes, and reads the installed diagonal back once
// (P * n, at the first entry of each round): it reads x once and writes
// each slot once, the diagonal at the install and every other slot at the
// step that reaches it. What is left is latency:
// each entry is a few integer operations, a shuffle and a store per lane,
// in sequence. The copy is bitwise: the element type only sets the carrier
// width (2 or 4 bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxEntries = 128;  // the schedule travels in the kernel's parameters
constexpr int kMaxLanes = 32;     // ranks of one column in one warp
constexpr int kBatch = 8;         // P > 32: moving slots loaded before any is stored

struct Entry {
  int step, dir, rounds, active;
  long long split;
};

struct Schedule {
  int count;
  Entry e[kMaxEntries];
};

// Where a group's ranks and slots lie, in bytes: group (a, b) of G0 x G1
// (blockIdx.y = a * G1 + b) reads rank d's shard at a * xa + b * xb + d * xd
// of x and keeps rank d's slot s at a * ba + b * bb + d * bd + s * slot of
// buf, element j of a shard or slot j elements further. The contiguous
// (G, P, n) / (G, P, P, n) is G1 = 1, xd = slot, xa = P * slot, bd = P *
// slot, ba = P * bd; a ring over a middle mesh axis of a stacked tensor
// (ranks numbered row-major, the axes after it the inner groups) reads its
// shards where they lie, at a rank stride of G1 shards.
struct Layout {
  long long g1, xa, xb, xd, ba, bb, bd;
};

// x in (-p, 2p) -> x mod p, without a division.
__device__ __forceinline__ int wrap(int x, int p) { return x < 0 ? x + p : x >= p ? x - p : x; }

// Whether rank d's slot moves at this step, and from which slot (src).
__device__ __forceinline__ bool moves(int d, int p, int step, int dir, int rounds, int active,
                                      int* src) {
  *src = wrap(d - dir * step, p);
  return rounds == 1 || *src % rounds == active;
}

__device__ __forceinline__ bool continues(const Entry& prev, const Entry& e) {
  return prev.dir == e.dir && prev.split == e.split && prev.rounds == e.rounds &&
         prev.active == e.active && prev.step + 1 == e.step;
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

// Rank d's move of one entry on the column at byte `col`: its slot src to
// rank d + dir's slot src, if the round mask moves it.
template <typename V>
__device__ __forceinline__ void move_one(char* base, int d, int p, long long rank_bytes,
                                         long long slot_bytes, long long col, int step, int dir,
                                         int rounds, int active) {
  int src;
  if (moves(d, p, step, dir, rounds, active, &src))
    *reinterpret_cast<V*>(base + wrap(d + dir, p) * rank_bytes + src * slot_bytes + col) =
        *reinterpret_cast<const V*>(base + d * rank_bytes + src * slot_bytes + col);
}

// The entries, staged in shared memory with whether each continues the one
// before: read from the parameters at every entry, they would cost a trip
// to memory on every thread's critical path.
__device__ __forceinline__ void stage(const Schedule& s, Entry* entries, bool* chained) {
  for (int k = threadIdx.x; k < s.count; k += kThreads) {
    entries[k] = s.e[k];
    chained[k] = k > 0 && continues(s.e[k - 1], s.e[k]);
  }
  __syncthreads();
}

// T: the element's carrier (2 or 4 bytes); V: what a lane moves at once,
// uint4 (16 bytes) where x and every slot start on a 16-byte boundary, else T.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(const T* __restrict__ x, T* buf, int p, int width, long long n,
                          const Layout lay, const __grid_constant__ Schedule s) {
  __shared__ Entry entries[kMaxEntries];
  __shared__ bool chained[kMaxEntries];
  stage(s, entries, chained);
  constexpr int kVec = sizeof(V) / sizeof(T);
  const int d = threadIdx.x % width;
  const long long c =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / width * kVec;
  const bool live = d < p && c < n;  // the other lanes only shuffle
  const long long slot_bytes = n * static_cast<long long>(sizeof(T));
  const long long ga = blockIdx.y / lay.g1, gb = blockIdx.y % lay.g1;
  char* base = reinterpret_cast<char*>(buf) + ga * lay.ba + gb * lay.bb;
  const long long col = c * static_cast<long long>(sizeof(T));
  if (x != nullptr && live)  // rank d's own shard into its own slot
    *reinterpret_cast<V*>(base + d * lay.bd + d * slot_bytes + col) =
        *reinterpret_cast<const V*>(reinterpret_cast<const char*>(x) + ga * lay.xa +
                                    gb * lay.xb + d * lay.xd + col);
  V held{};  // what rank d stored at the previous entry
  for (int k = 0; k < s.count; ++k) {
    const Entry en = entries[k];
    const int dir = c + kVec <= en.split ? en.dir : -en.dir;
    const V from_prev = shfl(held, wrap(d - dir, p), width);
    if (live) {
      if (c + kVec <= en.split || c >= en.split) {
        int src;
        if (moves(d, p, en.step, dir, en.rounds, en.active, &src)) {
          const V v = chained[k] ? from_prev
                                 : *reinterpret_cast<const V*>(base + d * lay.bd +
                                                               src * slot_bytes + col);
          *reinterpret_cast<V*>(base + wrap(d + dir, p) * lay.bd + src * slot_bytes + col) = v;
          held = v;
        }
      } else {  // the split falls inside this vector; every entry chained to
                // this one has the same split, so `held` is not read
        for (int j = 0; j < kVec; ++j)
          move_one<T>(base, d, p, lay.bd, slot_bytes, col + j * static_cast<long long>(sizeof(T)),
                      en.step, c + j < en.split ? en.dir : -en.dir, en.rounds, en.active);
      }
    }
    __syncwarp();
  }
}

// P > 32: one thread per column installs every rank's shard and runs every
// rank's moves, kBatch slots loaded before any is stored, each entry's
// slots loaded from memory.
template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_wide_kernel(const T* __restrict__ x, T* buf, int p, long long n,
                               const Layout lay, const __grid_constant__ Schedule s) {
  __shared__ Entry entries[kMaxEntries];
  __shared__ bool chained[kMaxEntries];
  stage(s, entries, chained);
  constexpr int kVec = sizeof(V) / sizeof(T);
  const long long c = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (c >= n) return;
  const long long slot_bytes = n * static_cast<long long>(sizeof(T));
  const long long ga = blockIdx.y / lay.g1, gb = blockIdx.y % lay.g1;
  char* base = reinterpret_cast<char*>(buf) + ga * lay.ba + gb * lay.bb;
  const long long col = c * static_cast<long long>(sizeof(T));
  if (x != nullptr) {
    const char* xg = reinterpret_cast<const char*>(x) + ga * lay.xa + gb * lay.xb;
    for (int d = 0; d < p; ++d)
      *reinterpret_cast<V*>(base + d * lay.bd + d * slot_bytes + col) =
          *reinterpret_cast<const V*>(xg + d * lay.xd + col);
  }
  for (int k = 0; k < s.count; ++k) {
    const Entry en = entries[k];
    if (c + kVec <= en.split || c >= en.split) {
      const int dir = c + kVec <= en.split ? en.dir : -en.dir;
      for (int d0 = 0; d0 < p; d0 += kBatch) {
        V v[kBatch];
        long long dst[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int d = d0 + j;
          int src;
          dst[j] = -1;
          if (d < p && moves(d, p, en.step, dir, en.rounds, en.active, &src)) {
            v[j] = *reinterpret_cast<const V*>(base + d * lay.bd + src * slot_bytes + col);
            dst[j] = wrap(d + dir, p) * lay.bd + src * slot_bytes + col;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (dst[j] >= 0) *reinterpret_cast<V*>(base + dst[j]) = v[j];
      }
    } else {  // the split falls inside this vector: element by element
      for (int j = 0; j < kVec; ++j)
        for (int d = 0; d < p; ++d)
          move_one<T>(base, d, p, lay.bd, slot_bytes, col + j * static_cast<long long>(sizeof(T)),
                      en.step, c + j < en.split ? en.dir : -en.dir, en.rounds, en.active);
    }
  }
}

template <typename T, typename V>
void launch_kernel(const void* x, void* buf, long long groups, int p, long long n,
                   const Layout& lay, const Schedule& s, cudaStream_t stream) {
  const long long columns = (n + sizeof(V) / sizeof(T) - 1) / (sizeof(V) / sizeof(T));
  if (p <= kMaxLanes) {
    int width = 1;
    while (width < p) width *= 2;
    const long long threads = columns * width;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                    static_cast<unsigned>(groups));
    ring_allgather_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(buf), p, width, n, lay, s);
  } else {
    const dim3 grid(static_cast<unsigned>((columns + kThreads - 1) / kThreads),
                    static_cast<unsigned>(groups));
    ring_allgather_wide_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(buf), p, n, lay, s);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* buf, long long groups, int p, long long n,
                   const Layout& lay, const Schedule& s, cudaStream_t stream) {
  const long long strides = lay.xa | lay.xb | lay.xd | lay.ba | lay.bb | lay.bd;
  if (((reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(x)) & 15) == 0 &&
      (n * static_cast<long long>(sizeof(T))) % 16 == 0 && strides % 16 == 0)
    launch_kernel<T, uint4>(x, buf, groups, p, n, lay, s, stream);
  else
    launch_kernel<T, T>(x, buf, groups, p, n, lay, s, stream);
  return cudaGetLastError();
}

}  // namespace

// Installs x's shards in buf's diagonal, unless x is null, then runs
// `count` schedule entries on buf, in order, in one launch, for g0 x g1
// groups of p ranks. `strides` is host memory, six element strides: x's
// (a, b, rank), then buf's (a, b, rank); a slot of buf is n contiguous
// elements, its P slots at a stride of n (see Layout). `entries` is host
// memory, five values per entry: step, dir, split, rounds, active_round.
// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks arguments: dtype 0 (f32), 1 (bf16) or 2 (f16), g0 * g1 <= 65535,
// 0 <= count <= 128 (1 or more when x is null), and per entry
// 0 <= step < p - 1, dir = +-1, 0 <= split <= n, p % rounds == 0,
// 0 <= active_round < rounds.
extern "C" int ring_allgather(const void* x, void* buf, int dtype, long long g0, long long g1,
                              int p, long long n, const long long* strides,
                              const long long* entries, int count, void* stream) {
  if (count < (x == nullptr ? 1 : 0) || count > kMaxEntries || g1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule s;
  s.count = count;
  for (int k = 0; k < count; ++k) {
    const long long* e = entries + 5 * k;
    s.e[k] = Entry{static_cast<int>(e[0]), static_cast<int>(e[1]), static_cast<int>(e[3]),
                   static_cast<int>(e[4]), e[2]};
  }
  const long long elt = dtype == 0 ? 4 : 2;
  const Layout lay{g1, strides[0] * elt, strides[1] * elt, strides[2] * elt,
                   strides[3] * elt, strides[4] * elt, strides[5] * elt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 || dtype == 2)
    err = launch<uint16_t>(x, buf, g0 * g1, p, n, lay, s, st);
  else if (dtype == 0)
    err = launch<uint32_t>(x, buf, g0 * g1, p, n, lay, s, st);
  return static_cast<int>(err);
}
