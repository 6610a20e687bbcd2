// The one-shot device query's ring filter for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it replaces phases 2-4 of the reference's jnp
// _device_query_jit (src/repro/core/distributed.py), which XLA fuses on the
// TPU and which the port first wrote as torch ops over a padded (Q, P, M)
// cube (P pivots, M the widest member list).  The flattened net keeps one
// huge pivot per shard, so M is near a shard's size while the mean list is
// tiny: the cube held 120-183x more slots than there are (query, window)
// pairs.  This filter visits only the real (pivot, member) pairs, stored
// once per FlatNet version in CSR order (pivot-major, each list in its
// stored order):
//
//   dp      (Q, P) f32   query-pivot distances (the pivot launch)
//   pradius (P,) f32     pivot radii
//   pivot   (Nv,) int32  pivot row of each pair
//   id      (Nv,) int32  window id of each pair
//   mdist   (Nv,) f32    delta(pivot, member)
//
// Each of the Q * Nv (query, pair) slots gets the reference's verdict, with
// the same f32 operations (one IEEE add or subtract each, no FMA) and eps
// rounded to f32 as torch's comparison with a Python float rounds it:
//
//   dp + pradius <= eps        accept the whole list   -> hit, free
//   dp - pradius >  eps        prune the whole list
//   dp + mdist   <= eps        accept the member       -> hit, free
//   |dp - mdist| <= eps < hi   the member survives     -> exact evaluation
//
// Two passes, one thread a slot, slots in blocks of TILE contiguous slots:
//
//   pass 1 (ring_verdicts_kernel) writes free hits straight into the (Q, N)
//     byte mask and counts each block's survivors (ballot and popc a warp);
//   the scan (ring_scan_kernel, one block) turns the counts into each
//     block's first output row; its last element is the survivor count,
//     which the host reads to size the outputs exactly;
//   pass 2 (ring_rows_kernel) recomputes the verdicts and writes each
//     survivor at its scanned row: q_of, w_of (int64), the query's length
//     (int32), and the two operand rows qs[q] and data[w] as they are, in
//     the layout the wavefront kernel takes.  A warp stages its survivors'
//     (q, w) in shared memory and copies their rows together, so the
//     writes of a warp are one contiguous run.
//
// Order: slot s = q * Nv + j.  A block owns slots [b * TILE, (b+1) * TILE),
// sub-tile by sub-tile, warp by warp, lane by lane, so the scanned row of a
// survivor is its rank in slot order, which is the (q, p, m) row-major
// order torch.nonzero gave over the padded cube: the CSR keeps each
// pivot's valid members in their stored order.  A single pass with an
// atomic cursor would lose that order and need outputs sized for the worst
// case (Q * Nv rows).
//
// What bounds it: bytes.  Per slot pass 1 reads 12 bytes of the pair and 8
// of dp and pradius, all from L2 after the first query (the pairs of a 20,000
// window fleet are 240 KB); pass 2 reads them again and writes 20 bytes plus
// the two rows per survivor.  No operation is heavier than an add.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;                 // sub-tiles of a block
constexpr int TILE = THREADS * ITEMS;    // slots of a block
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int SKIP = 0, HIT = 1, NEED = 2;

struct Ring {
  const float* dp;
  const float* pradius;
  const int* pivot;
  const int* id;
  const float* mdist;
  long long nv;      // pairs
  long long slots;   // Q * nv
  int P;
  float eps;
};

// the verdict of slot s; *q and *w are set for every slot inside the range
__device__ __forceinline__ int verdict(const Ring& r, long long s, int* q,
                                      int* w) {
  if (s >= r.slots) return SKIP;
  const long long qq = s / r.nv;
  const long long j = s - qq * r.nv;
  const int p = r.pivot[j];
  const float dp = r.dp[qq * r.P + p];
  const float pr = r.pradius[p];
  *q = (int)qq;
  *w = r.id[j];
  if (__fadd_rn(dp, pr) <= r.eps) return HIT;
  if (__fsub_rn(dp, pr) > r.eps) return SKIP;
  const float md = r.mdist[j];
  const float hi = __fadd_rn(dp, md);
  if (hi <= r.eps) return HIT;
  const float lo = fabsf(__fsub_rn(dp, md));
  return (lo <= r.eps && hi > r.eps) ? NEED : SKIP;
}

__global__ void __launch_bounds__(THREADS)
ring_verdicts_kernel(Ring r, uint8_t* hits, long long n_cols,
                     int* block_count) {
  __shared__ int warp_total[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  int mine = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    int q = 0, w = 0;
    const int v = verdict(r, base + it * THREADS + threadIdx.x, &q, &w);
    if (v == HIT) hits[(long long)q * n_cols + w] = 1;
    mine += __popc(__ballot_sync(FULL, v == NEED));
  }
  if (lane == 0) warp_total[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int k = 0; k < WARPS; ++k) t += warp_total[k];
    block_count[blockIdx.x] = t;
  }
}

// exclusive scan of n block counts into offset[0..n); offset[n] = the sum
__global__ void __launch_bounds__(SCAN_THREADS)
ring_scan_kernel(const int* count, long long* offset, int n) {
  __shared__ long long warp_sum[SCAN_THREADS / 32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const long long v = i < n ? count[i] : 0;
    long long x = v;  // inclusive scan inside the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long s = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(FULL, s, d);
        if (lane >= d) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    if (i < n) offset[i] = carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) offset[n] = carry;
}

// the n rows src[row[0]], ..., src[row[n-1]] (each `words` units) into
// dst[0 .. n * words), by the 32 lanes of one warp
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          const int* row, int n,
                                          unsigned words, int lane) {
  const unsigned total = (unsigned)n * words;
  for (unsigned k = lane; k < total; k += 32) {
    const unsigned r = k / words;
    dst[k] = src[(long long)row[r] * words + (k - r * words)];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_rows_kernel(Ring r, const long long* block_offset, const int* q_lens,
                 const T* xs, unsigned x_words, const T* ys,
                 unsigned y_words, long long* q_of, long long* w_of,
                 int* q_len_of, T* x_rows, T* y_rows) {
  __shared__ int warp_n[WARPS];
  __shared__ int sq[WARPS][32];
  __shared__ int sw[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE;
  long long at = block_offset[blockIdx.x];
  for (int it = 0; it < ITEMS; ++it) {
    int q = 0, w = 0;
    const int v = verdict(r, base + it * THREADS + threadIdx.x, &q, &w);
    const unsigned need = __ballot_sync(FULL, v == NEED);
    if (lane == 0) warp_n[warp] = __popc(need);
    __syncthreads();
    long long start = at;
    long long total = 0;
    for (int k = 0; k < WARPS; ++k) {
      if (k < warp) start += warp_n[k];
      total += warp_n[k];
    }
    if (v == NEED) {
      const int rank = __popc(need & below);
      const long long row = start + rank;
      q_of[row] = q;
      w_of[row] = w;
      q_len_of[row] = q_lens[q];
      sq[warp][rank] = q;
      sw[warp][rank] = w;
    }
    __syncwarp();
    const int n = __popc(need);
    if (n) {
      copy_rows(x_rows + start * x_words, xs, sq[warp], n, x_words, lane);
      copy_rows(y_rows + start * y_words, ys, sw[warp], n, y_words, lane);
    }
    at += total;
    __syncthreads();  // warp_n, sq and sw are rewritten by the next sub-tile
  }
}

Ring make_ring(const float* dp, const float* pradius, const int* pivot,
               const int* id, const float* mdist, long long nv, long long Q,
               int P, float eps) {
  return Ring{dp, pradius, pivot, id, mdist, nv, Q * nv, P, eps};
}

int blocks_of(long long slots) {
  const long long b = (slots + TILE - 1) / TILE;
  return b > INT_MAX ? -1 : (int)b;
}

}  // namespace

extern "C" {

// Slots a block of either pass owns: the wrapper sizes the block counts
// (ceil(Q * Nv / tile)) and offsets (one more) from it.
int ring_filter_tile(void) { return TILE; }

// Pass 1 and the scan on ``stream``: free hits into ``hits`` (row stride
// ``n_cols`` bytes), ``block_offset[nblocks]`` the survivor count.
// Returns cudaGetLastError() (0 on success); asynchronous.
int ring_filter_verdicts(const float* dp, const float* pradius,
                         const int* pivot, const int* id, const float* mdist,
                         long long nv, long long Q, int P, float eps,
                         uint8_t* hits, long long n_cols, int* block_count,
                         long long* block_offset, int device, void* stream) {
  const int nblocks = blocks_of(Q * nv);
  if (nv <= 0 || Q <= 0 || P <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Ring r = make_ring(dp, pradius, pivot, id, mdist, nv, Q, P, eps);
  ring_verdicts_kernel<<<nblocks, THREADS, 0, st>>>(r, hits, n_cols,
                                                    block_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ring_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(block_count, block_offset,
                                               nblocks);
  return (int)cudaGetLastError();
}

// Pass 2 on ``stream``: each survivor's q, w, query length and operand rows
// at its scanned row.  ``x_bytes`` / ``y_bytes`` are the bytes of one row of
// ``xs`` (Q rows) and ``ys`` (N rows); both are copied in 4-byte words when
// every size and pointer allows, else byte by byte.  Returns
// cudaGetLastError() (0 on success); asynchronous.
int ring_filter_rows(const float* dp, const float* pradius, const int* pivot,
                     const int* id, const float* mdist, long long nv,
                     long long Q, int P, float eps,
                     const long long* block_offset, const int* q_lens,
                     const void* xs, long long x_bytes, const void* ys,
                     long long y_bytes, long long* q_of, long long* w_of,
                     int* q_len_of, void* x_rows, void* y_rows, int device,
                     void* stream) {
  const int nblocks = blocks_of(Q * nv);
  if (nv <= 0 || Q <= 0 || P <= 0 || nblocks <= 0 || x_bytes <= 0 ||
      y_bytes <= 0 || x_bytes * 32 > UINT_MAX || y_bytes * 32 > UINT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Ring r = make_ring(dp, pradius, pivot, id, mdist, nv, Q, P, eps);
  const uintptr_t addr = (uintptr_t)xs | (uintptr_t)ys | (uintptr_t)x_rows |
                         (uintptr_t)y_rows;
  if (x_bytes % 4 == 0 && y_bytes % 4 == 0 && addr % 4 == 0) {
    ring_rows_kernel<uint32_t><<<nblocks, THREADS, 0, st>>>(
        r, block_offset, q_lens, (const uint32_t*)xs,
        (unsigned)(x_bytes / 4), (const uint32_t*)ys,
        (unsigned)(y_bytes / 4), q_of, w_of, q_len_of, (uint32_t*)x_rows,
        (uint32_t*)y_rows);
  } else {
    ring_rows_kernel<uint8_t><<<nblocks, THREADS, 0, st>>>(
        r, block_offset, q_lens, (const uint8_t*)xs, (unsigned)x_bytes,
        (const uint8_t*)ys, (unsigned)y_bytes, q_of, w_of, q_len_of,
        (uint8_t*)x_rows, (uint8_t*)y_rows);
  }
  return (int)cudaGetLastError();
}

const char* ring_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
