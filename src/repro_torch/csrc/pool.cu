// Pool-completion scan with the staging-ring (RNR) mask, one launch for a
// whole (R, n) matrix of sorted f64 arrival rows.
//
// Hopper counterpart of `pool_scan_rows` (src/repro/kernels/pool.py:53) and
// `pool_completion_rows` (src/repro/kernels/pool.py:86). A W-worker pool
// with deterministic service s finishes chunk e = i * W + lane at
//
//     done[e] = (i + 1) * s + max_{j <= i} (a[j * W + lane] - j * s)
//
// and chunk k is dropped when the chunk `staging` places ahead of it is
// still unserviced at k's arrival: mask[k] = done[k - staging] > a[k].
//
// Bound on the H100: HBM bytes. Every element is read once (8 B) and
// written twice (8 B done, 1 B mask): 17 B, 0.0425 ms at broadcast A's
// (511, 16384) at 3.35 TB/s. What held the first design (a Hillis-Steele
// scan of one element a thread, 2 log2(1024 / W) + 2 barriers per tile of
// 1,024 elements, no load in flight while a tile was scanned) at 36 % of
// that (0.1174 ms on the device, NVIDIA H100 80GB HBM3 at 700 W) was the
// barriers and the idle memory, not the arithmetic. This design takes
// 0.0623 ms there (68 %), and 0.0194 at broadcast B's (63, 16384), W = 1,
// whose 63 rows fill 63 of the 132 SMs (same card; PERF.md section 6).
//
// The design. A block of 512 threads owns whole rows (a persistent grid,
// one block per SM: the kernel takes 128 registers a thread; rows strided
// over the blocks) and walks each row in tiles of C = G * W elements,
// G = L * S tile rows, C <= 4,096:
//  - the tiles of all the block's rows form one sequence, double-buffered
//    in shared memory: tile q + 1 is copied in with 8-byte cp.async while
//    tile q is scanned, so loads stay in flight across tiles and rows;
//  - each (lane, segment) thread takes L consecutive tile rows of one lane
//    (S segments a lane, S a power of two with S * W <= 512, L = 4096 /
//    (S * W)), a serial max over them. The S * W segment totals are scanned
//    per lane with warp shuffles (and, for S > 32, one pass over the warps'
//    totals), seeded with the lane's carry from the row's earlier tiles.
//    A second serial pass over the same L rows writes done into shared
//    memory. About five barriers a tile of up to 4,096 elements. For W >
//    256 (S = 1) a thread owns whole lanes (at most two) and scans them
//    serially, each lane's carry in shared memory (two in registers made
//    the kernel spill);
//  - the tile is stored segment row by segment row (slot k * RS + g * W +
//    lane for tile row g * L + k, RS = S * W padded to W mod 16 doubles),
//    so that a warp of (lane, segment) threads reads consecutive slots and
//    a warp of consecutive elements hits distinct banks;
//  - done leaves shared memory coalesced, and the mask is computed beside
//    it: done[k - staging] comes from shared memory when it lies in this
//    tile, else from global memory, where this block wrote it in an earlier
//    tile of the row (visible after the barrier that opens the tile; the
//    load is issued at the tile's start, so it lands while the tile is
//    scanned). One launch a call, as before.
//
// Exactness. The max is exact and max_keep_first is associative (it picks
// the first NaN, else the first largest value), so any order of the scan
// gives numpy's bits; ties keep the earlier value, as numpy's
// maximum.accumulate does. The subtraction and the final add are per
// element and are written with __dmul_rn / __dsub_rn / __dadd_rn (and the
// file is built with -fmad=false) so that `a - i*s` and `m + (i+1)*s` each
// round twice, as in numpy: a fused multiply-add would change the bits.
// +inf padding comes back +inf. 1 <= W <= 1024.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                      // elements a tile holds at most
constexpr int kPerThread = kTile / kThreads;     // elements a thread copies and stores
constexpr int kCap = kTile + 16 * 16;            // slots of a tile buffer: L <= 16 rows pad
constexpr int kTotCap = kThreads + kThreads / 2; // segment totals, W * (S + 1) slots
constexpr int kStages = 2;                       // tile buffers: one scanned, one in flight
constexpr int kMaxW = 1024;                     // lanes (workers) at most
constexpr size_t kSmem = ((kStages + 1) * kCap + kTotCap + kWarps + kMaxW) * sizeof(double);

// How a block cuts a row (computed once a call, on the host).
struct Plan {
  int w;      // workers (lanes)
  int s;      // segments a lane in a tile (a power of two; 1 when W > 256)
  int log_s;
  int l;      // tile rows a segment
  int g;      // tile rows (l * s)
  int c;      // tile elements (g * w)
  int rs;     // slots between a segment's consecutive rows
  unsigned long long w_inv, l_inv;  // ceil(2^32 / w), ceil(2^32 / l): see quot
};

// x / d for 0 <= x < 2^13 and d <= 1024 by one multiply with inv = ceil(2^32
// / d): inv * d = 2^32 + r with r < d, so x * inv / 2^32 exceeds x / d by
// less than x * d / 2^32 < 1 / d, never reaching the next integer
__device__ __forceinline__ int quot(int x, unsigned long long inv) {
  return static_cast<int>((static_cast<unsigned long long>(x) * inv) >> 32);
}

// max that keeps `earlier` on ties and propagates a NaN in `earlier`,
// like numpy's maximum(earlier, later)
__device__ __forceinline__ double max_keep_first(double earlier, double later) {
  return (earlier >= later || isnan(earlier)) ? earlier : later;
}

// x = a - i * s, each product and difference rounded on its own (i is an
// integer held exactly in a double: counted up by 1.0, never converted per
// element)
__device__ __forceinline__ double shifted(double a, double i, double s) {
  return __dsub_rn(a, __dmul_rn(i, s));
}

__device__ __forceinline__ double finished(double m, double i, double s) {
  return __dadd_rn(m, __dmul_rn(i + 1.0, s));
}

// rows of a lane that hold one of the tile's `rem` elements, at most `cap`
// from row `first` on
__device__ __forceinline__ int rows_in(int rem, int lane, const Plan& p, int first, int cap) {
  const int rows = (rem > lane ? quot(rem - lane + p.w - 1, p.w_inv) : 0) - first;
  return rows < 0 ? 0 : rows < cap ? rows : cap;
}

// the shared-memory slot of a tile's element e (0 <= e < c)
__device__ __forceinline__ int slot_of(int e, const Plan& p) {
  const int r = quot(e, p.w_inv), lane = e - r * p.w, seg = quot(r, p.l_inv);
  return (r - seg * p.l) * p.rs + seg * p.w + lane;
}

__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
pool_rows_kernel(const double* __restrict__ a, double* done, bool* mask, long long rows,
                 long long n, Plan p, double s, long long staging) {
  extern __shared__ double smem[];
  double* const dbuf = smem + kStages * kCap;        // the tile's done
  double* const tot = smem + (kStages + 1) * kCap;   // segment totals, then their exclusive prefixes
  double* const wt = tot + kTotCap;      // warp totals (S > 32)
  double* const lane_carry = wt + kWarps;  // S = 1: each lane's max so far in the row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  int slot[kPerThread];  // the slot of this thread's j-th element in every tile
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = t + j * kThreads;
    slot[j] = e < p.c ? slot_of(e, p) : -1;
  }
  const long long tiles = (n + p.c - 1) / p.c;
  const long long total = (rows - blockIdx.x + gridDim.x - 1) / gridDim.x * tiles;
  const int sw = p.s * p.w;
  const int seg = t / p.w, seg_lane = t - seg * p.w;                    // segment pass
  const int scan_lane = t >> p.log_s, scan_seg = t & (p.s - 1);         // segment scan
  const int span = p.s < 32 ? p.s : 32;                                 // lanes a scan group spans

  // tile q of the sequence into buffer q % kStages: one commit group a tile,
  // empty past the last, so that a wait for all but the newest group is a
  // wait for the tile before it
  auto fetch = [&](long long q) {
    if (q < total) {
      const long long row = blockIdx.x + q / tiles * gridDim.x, t0 = q % tiles * p.c;
      const double* src = a + row * n + t0;
      double* buf = smem + q % kStages * kCap;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = t + j * kThreads;
        if (slot[j] >= 0 && t0 + e < n) copy8(buf + slot[j], src + e);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  double carry = -INFINITY;                 // S > 1: lane scan_lane's max so far in the row
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  for (long long q = 0; q < total; ++q) {
    const long long row = blockIdx.x + q / tiles * gridDim.x, tile = q % tiles;
    const long long t0 = tile * p.c;                               // the tile's first element
    const int rem = static_cast<int>(n - t0 < p.c ? n - t0 : p.c);  // and its elements
    const double i0 = static_cast<double>(tile * p.g);             // its first row index i
    double* dr = done + row * n + t0;
    const double* buf = smem + q % kStages * kCap;
    // tile q is in for this thread, the tiles after it may be in flight
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();        // tile q is in for every thread; tile q - 1 is finished
    fetch(q + kStages - 1); // into tile q - 1's buffer
    if (tile == 0) carry = -INFINITY;

    // done[k - staging] where it lies in the row's earlier tiles, which this
    // block wrote before the barrier; the loads land while the tile is scanned
    const bool masked = mask != nullptr && t0 + rem > staging;  // some k - staging >= 0
    double ref[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = t + j * kThreads;
      const long long k = e - staging;  // relative to t0
      ref[j] = masked && e < rem && k < 0 && t0 + k >= 0 ? dr[k] : 0.0;
    }

    if (p.s == 1) {  // W > 256: a thread scans whole lanes (t, t + 512)
      for (int ln = t; ln < p.w; ln += kThreads) {
        double m = tile == 0 ? -INFINITY : lane_carry[ln], i = i0;
        const int rows = rows_in(rem, ln, p, 0, p.g);
        for (int r = 0, sl = ln; r < rows; ++r, sl += p.rs, i += 1.0) {
          m = max_keep_first(m, shifted(buf[sl], i, s));
          dbuf[sl] = finished(m, i, s);
        }
        lane_carry[ln] = m;  // read again only by this thread, in the row's next tile
      }
    } else {
      // (lane, segment) serial maxima over the segment's valid rows
      const int rows = t < sw ? rows_in(rem, seg_lane, p, seg * p.l, p.l) : 0;
      const double iseg = i0 + static_cast<double>(seg * p.l);
      if (t < sw) {
        double m = -INFINITY, i = iseg;
        for (int k = 0, sl = t; k < rows; ++k, sl += p.rs, i += 1.0)
          m = max_keep_first(m, shifted(buf[sl], i, s));
        tot[seg_lane * (p.s + 1) + seg] = m;
      }
      __syncthreads();
      // each lane's segments, scanned: a group of `span` threads per lane
      // in a warp, and the lane's warps in order when S > 32
      const bool live = t < sw;
      const int ti = scan_lane * (p.s + 1) + scan_seg;
      double v = live ? tot[ti] : -INFINITY;
      const int gl = lane & (span - 1);
      for (int off = 1; off < span; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, v, off);
        if (gl >= off) v = max_keep_first(o, v);
      }
      double before = __shfl_up_sync(0xffffffffu, v, 1);  // the segments before, in this warp
      if (gl == 0) before = -INFINITY;
      double lane_total;
      if (p.s > 32) {
        if (lane == 31) wt[warp] = v;
        __syncthreads();
        const int w0 = warp - (scan_seg >> 5);
        double earlier = -INFINITY;
        lane_total = -INFINITY;
        for (int h = w0; h < w0 + (p.s >> 5); ++h) {
          if (h < warp) earlier = max_keep_first(earlier, wt[h]);
          lane_total = max_keep_first(lane_total, wt[h]);
        }
        before = max_keep_first(earlier, before);
      } else {
        lane_total = __shfl_sync(0xffffffffu, v, (lane & ~(span - 1)) + span - 1);
      }
      if (live) {
        tot[ti] = max_keep_first(carry, before);
        carry = max_keep_first(carry, lane_total);
      }
      __syncthreads();
      // the second serial pass writes done
      if (t < sw) {
        double m = tot[seg_lane * (p.s + 1) + seg], i = iseg;
        for (int k = 0, sl = t; k < rows; ++k, sl += p.rs, i += 1.0) {
          m = max_keep_first(m, shifted(buf[sl], i, s));
          dbuf[sl] = finished(m, i, s);
        }
      }
    }
    __syncthreads();  // the tile's done is in dbuf

    // done out, coalesced, and the mask beside it
    bool* mr = mask == nullptr ? nullptr : mask + row * n + t0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = t + j * kThreads;
      if (e >= rem) break;
      dr[e] = dbuf[slot[j]];
      if (mr == nullptr) continue;
      const long long k = e - staging;  // relative to t0
      bool drop = false;
      if (masked && t0 + k >= 0) {
        const double d = k >= 0 ? dbuf[slot_of(static_cast<int>(k), p)] : ref[j];
        drop = d > buf[slot[j]];
      }
      mr[e] = drop;
    }
  }
}

Plan plan_for(int w) {
  Plan p;
  p.w = w;
  p.s = 1;
  p.log_s = 0;
  if (2 * w <= kThreads)
    while (2 * p.s * w <= kThreads) {
      p.s *= 2;
      ++p.log_s;
    }
  p.l = kTile / (p.s * w);  // 8 to 15 when S > 1, 4 to 15 when S = 1
  p.g = p.l * p.s;
  p.c = p.g * w;
  // RS = S * W, padded so that RS = W (mod 16): consecutive elements on
  // distinct banks across a row step
  p.rs = p.s == 1 ? w : p.s * w + (((w * (1 - p.s)) % 16) + 16) % 16;
  p.w_inv = ((1ULL << 32) + w - 1) / w;
  p.l_inv = ((1ULL << 32) + p.l - 1) / p.l;
  return p;
}

int blocks_per_sm = 0;
int sm_count = 0;

}  // namespace

// Returns 0 on success, else the CUDA error of the set-up or the launch.
// The caller checks arguments: a and done contiguous (rows, n) f64, mask a
// contiguous (rows, n) bool or null (no mask), rows >= 1, n >= 1, 1 <= w <=
// 1024, staging >= 0.
extern "C" int pool_completion_rows(const void* a, void* done, void* mask, long long rows,
                                    long long n, int w, double s, long long staging,
                                    void* stream) {
  if (blocks_per_sm == 0) {  // first call: dynamic shared memory above 48 KB, grid size
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pool_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmem));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_rows_kernel, kThreads,
                                                          kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks_per_sm = per_sm > 0 ? per_sm : 1;
  }
  const long long slots = static_cast<long long>(sm_count) * blocks_per_sm;
  const unsigned grid = static_cast<unsigned>(rows < slots ? rows : slots);
  pool_rows_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<double*>(done), static_cast<bool*>(mask), rows,
      n, plan_for(w), s, staging);
  return static_cast<int>(cudaGetLastError());
}
