// Pairwise Euclidean distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_l2.py
// (_kernel, launched by _pairwise_l2_jit / pairwise_l2_pallas).  It computes
// the same function:
//
//   x (M, d) f32, y (N, d) f32, row-major and contiguous
//   -> out (M, N) f32, out[i, j] = sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0))
//
// The TPU kernel takes one (128, 128) output tile per grid step with both
// operand tiles whole in VMEM and the dot products on the MXU; its caller
// pads M and N to tile multiples.  Here nothing is padded: every load and
// store is guarded, so any M, N >= 1 and d >= 1 are taken as they are, and
// output offsets are 64-bit (M * N passes 2^31 at realistic sizes).
//
// What bounds it on this card: 2 M N d multiply-adds against (M + N) d + M N
// words of traffic, so at the embedding width (d = 960) it is bound by
// operations unless M or N is small (a probe batch of 64 rows against the
// database is bound by reading y once).  The design is the classic
// register-tiled product on the f32 cores, with no tensor cores: TF32 keeps
// about three decimal digits and would break the tolerance held against the
// f32 plain version.
//
//   * one block of 256 threads owns a 64 x 64 output tile; each thread holds
//     a 4 x 4 block of f32 accumulators (rows 4ty.., columns 4tx..);
//   * the d loop stages 64 x 16 slices of x and of y in shared memory,
//     transposed to k-major so a thread reads its 4 rows and its 4 columns
//     as one 16-byte load each (8 multiply-adds per shared load);
//   * both row norms are accumulated from the same staged slices (threads
//     0..63 take x's rows, 64..127 y's), so x and y are read from device
//     memory once per tile and never a second time for the norms;
//   * the epilogue is fused: norms, the -2xy term, the clamp at 0 and the
//     square root are applied in registers and only the distance is stored.
//
// Numerics: each dot product and norm is a sequential f32 sum over d with
// fused multiply-adds, so every entry is within the usual gamma_d bound of
// the exact value; the plain version (torch matmul, another summation order)
// agrees within (4d + 6) 2^-24 (|x|^2 + |y|^2) on squared distances.  Near
// 0 the square root magnifies that rounding (an entry of exact distance 0 may
// read ~3e-4 at unit norms), which is why parity is held on squares.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (fused multiply-add allowed: parity is by
// tolerance, not bit-equality).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;              // output rows and columns per block
constexpr int BK = 16;                // depth of one staged slice
constexpr int THREADS = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = TILE + 4;         // padded k-major row (16-byte aligned)
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(THREADS)
pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int M, int N, int d) {
  __shared__ __align__(16) float xs[BK][LDS];
  __shared__ __align__(16) float ys[BK][LDS];
  __shared__ float xn[TILE];
  __shared__ float yn[TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns 4tx .. 4tx+3 of the tile
  const int ty = tid / 16;  // output rows    4ty .. 4ty+3 of the tile
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads 0..63: |x_{m0+tid}|^2; 64..127: |y_{n0+tid-64}|^2

  for (int k0 = 0; k0 < d; k0 += BK) {
    // stage x[m0:m0+64, k0:k0+16] and y[n0:n0+64, k0:k0+16], k-major; each
    // warp reads two rows of 16 contiguous floats of each operand
#pragma unroll
    for (int p = 0; p < TILE * BK / THREADS; ++p) {
      const int e = tid + p * THREADS;
      const int r = e / BK;
      const int k = e % BK;
      const int gk = k0 + k;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xs[k][r] = (gm < M && gk < d) ? x[(size_t)gm * d + gk] : 0.f;
      ys[k][r] = (gn < N && gk < d) ? y[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();
    if (tid < TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(xs[k][tid], xs[k][tid], norm);
    } else if (tid < 2 * TILE) {
      const int c = tid - TILE;
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(ys[k][c], ys[k][c], norm);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < TILE) {
    xn[tid] = norm;
  } else if (tid < 2 * TILE) {
    yn[tid - TILE] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int gm = m0 + r;
    if (gm >= M) continue;
    float* row = out + (size_t)gm * (size_t)N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      const int gn = n0 + c;
      if (gn < N) {
        const float d2 = xn[r] + yn[c] - 2.f * acc[i][j];
        row[gn] = sqrtf(fmaxf(d2, 0.f));
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch one (M, N) distance matrix on ``stream``; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for an empty or
// negative shape, cudaErrorInvalidConfiguration when M needs more than
// 65535 row tiles.  Asynchronous: nothing is synchronised.
int pairwise_l2_launch(const float* x, const float* y, float* out, int M,
                       int N, int d, int device, void* stream) {
  if (M < 1 || N < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int grid_y = (M + TILE - 1) / TILE;
  if (grid_y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TILE - 1) / TILE, grid_y);
  pairwise_l2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, out,
                                                                 M, N, d);
  return (int)cudaGetLastError();
}

const char* pairwise_l2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
