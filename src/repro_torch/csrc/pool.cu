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
// The TPU kernel walks i with a fori_loop, the W lanes of a block of rows
// advancing together. Here one block owns one row and walks it in tiles of
// T = W * floor(1024 / W) elements (so W <= 1024), one element per thread:
// a Hillis-Steele scan with strides W, 2W, 4W, ... in shared memory runs
// every lane's prefix max at once, and a carry per lane in shared memory
// joins the tiles. The max is exact, so scanning in a tree instead of left
// to right gives the same bits; ties keep the earlier value, as numpy's
// maximum.accumulate does. The subtraction and the final add are per
// element and are written with __dmul_rn / __dsub_rn / __dadd_rn (and the
// file is built with -fmad=false) so that `a - i*s` and `m + (i+1)*s` each
// round twice, as in numpy: a fused multiply-add would change the bits.
// After the last tile a block-wide barrier makes the row's `done` visible
// to the whole block, which then writes the row's RNR mask.
//
// Bound: HBM bytes. The scan reads 8 B and writes 8 B per element; the mask
// reads 16 B (done and arrival) and writes 1 B. The design keeps every
// global access coalesced (consecutive threads on consecutive elements) and
// the recurrence in shared memory; at W = 8 a tile takes 7 scan steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// max that keeps `earlier` on ties and propagates a NaN in `earlier`,
// like numpy's maximum(earlier, later)
__device__ __forceinline__ double max_keep_first(double earlier, double later) {
  return (earlier >= later || isnan(earlier)) ? earlier : later;
}

__global__ void pool_rows_kernel(const double* __restrict__ a, double* done, bool* mask,
                                 long long n, int w, double s, long long staging) {
  extern __shared__ double smem[];
  double* tile = smem;              // kThreads
  double* carry = smem + kThreads;  // w
  const long long row = blockIdx.x;
  const double* ar = a + row * n;
  double* dr = done + row * n;
  const int t = threadIdx.x;
  const int tlen = (kThreads / w) * w;  // a multiple of w, so lane = t % w in every tile
  const int lane = t % w;
  for (int l = t; l < w; l += blockDim.x) carry[l] = -INFINITY;
  __syncthreads();

  for (long long t0 = 0; t0 < n; t0 += tlen) {
    const long long e = t0 + t;
    const bool live = t < tlen && e < n;
    const double i = static_cast<double>(e / w);
    double x = live ? __dsub_rn(ar[e], __dmul_rn(i, s)) : -INFINITY;
    for (int off = w; off < tlen; off <<= 1) {
      tile[t] = x;
      __syncthreads();
      if (t < tlen && t >= off) x = max_keep_first(tile[t - off], x);
      __syncthreads();
    }
    if (t < tlen) x = max_keep_first(carry[lane], x);
    __syncthreads();  // every thread has read its carry
    if (t < tlen && t >= tlen - w) carry[lane] = x;
    if (live) dr[e] = __dadd_rn(x, __dmul_rn(i + 1.0, s));
    __syncthreads();  // the carry is written before the next tile reads it
  }

  if (mask == nullptr) return;
  // the barrier above made this row's done visible to the whole block
  for (long long k = t; k < n; k += blockDim.x)
    mask[row * n + k] = k >= staging && dr[k - staging] > ar[k];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks arguments: a and done contiguous (rows, n) f64, mask a contiguous
// (rows, n) bool or null (no mask), rows >= 1, n >= 1, 1 <= w <= 1024,
// rows <= 2^31 - 1, staging >= 0.
extern "C" int pool_completion_rows(const void* a, void* done, void* mask, long long rows,
                                    long long n, int w, double s, long long staging,
                                    void* stream) {
  const size_t smem = (kThreads + w) * sizeof(double);
  pool_rows_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<double*>(done), static_cast<bool*>(mask), n,
      w, s, staging);
  return static_cast<int>(cudaGetLastError());
}
