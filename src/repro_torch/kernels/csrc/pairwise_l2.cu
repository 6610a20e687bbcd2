// Pairwise Euclidean distance matrix for Hopper (sm_90a): 3xTF32 on wgmma.
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
// pads M and N to tile multiples.  Here nothing is padded: TMA fills rows
// and columns past M, N and d with zeros, the plain loader guards every
// load, every store is guarded, and output offsets are 64-bit.
//
// What bounds it on this card.  At d = 960 the products are 2 M N d
// operations against (M + N) d + M N words: bound by operations unless M or
// N is small (64 probes against the 10,240-window database are bound by
// reading y once).  The f32 cores peak at 67 TFLOP/s, where cuBLAS SGEMM
// already is; only the tensor cores go faster, and TF32 keeps 11 bits.
// So the products run as 3xTF32: each operand v is split into
//   big = cvt.rna.tf32(v),  small = cvt.rna.tf32(v - big)  (v - big exact),
// and wgmma (m64nNk8, f32 accumulator) takes big.small, small.big and
// big.big, three products in one accumulator (small.small, ~2^-22 of
// x.y, is dropped).  The rounding is explicit: the tensor core would
// otherwise truncate the low 13 bits.  At 495 TFLOP/s TF32 that is 3 x
// 2MNd / 495e12 s: 0.78 ms at 8192 x 8192 x 960, against 1.93 ms for f32.
//
// Design:
//   * operands as they are: x and y are both K-major (d contiguous), which
//     is what TF32 wgmma takes (it has no transposed form), so nothing is
//     transposed.  B (y) is read from shared memory in the 128-byte-swizzled
//     K-major layout (8-row groups 1024 bytes apart, one 32-float k-block
//     per 128-byte row).  A (x) comes from registers: each thread reads its
//     m64k8 fragments from the staged raw x tile and splits them there, so
//     x needs no second tile and the tensor cores read no A from shared
//     memory.
//   * a ring of 4 k-blocks in shared memory.  Loader "tma": thread 0
//     keeps the ring full with cp.async.bulk.tensor (tensor maps made with
//     cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so the
//     library needs no -lcuda; 128-byte swizzle, zero fill out of bounds),
//     each stage completing on its own mbarrier.  TMA needs 16-byte row
//     strides, so for d % 4 != 0 (or a base not 16-byte aligned) loader
//     "plain" reads the same values with guarded loads (y into the same
//     shared layout, x straight into the fragments).  One consumer serves
//     both.
//   * the consumer threads split each arrived y k-block in place (big over
//     the raw value, small into a twin buffer) and their x fragments in
//     registers, accumulating both row norms in f32 from the same values,
//     so x and y are read from HBM once per tile and never again for the
//     norms; then each warpgroup issues 3 x 4 wgmma per k-block.  One
//     wgmma group stays in flight while the next stage is split; a stage is
//     refilled once the group that read it is done.
//   * tiles: "64x80" (one warpgroup, n = 80) when the 128 x 128 grid would
//     not fill the card twice over: 64 x 10,240 gives 128 CTAs on 132 SMs,
//     one wave, each streaming its y tile once.  "128x128" (two
//     warpgroups) otherwise.  The launcher reports its choice.
//   * the epilogue (norms, -2 acc, clamp at 0, sqrtf) is fused in registers.
//
// What holds the 128 x 128 tile below the tensor-core rate, by count (no
// profiler runs on the card's machine): at full rate an SM's wgmma reads
// B at 64 bytes a clock (a TF32 m64 product does 16 multiply-adds a byte of
// B, whatever n is), and the y split (16 KB read, 32 KB written a k-block),
// the TMA writes (32 KB) and the x fragment reads (16 KB) need about as
// much again against 128 bytes a clock of shared memory; each SM also
// pulls 32 KB a k-block from L2, 4.8 TB/s over the card at full rate.
//
// Accuracy, derived from the design (u = 2^-24, S = |x|^2 + |y|^2):
//   * split: x = big + small + r with |small| <= 2^-11 |x|, |r| <= 2^-22 |x|,
//     so big.big + big.small + small.big differs from x.y by at most
//     (|r_x y| + |x r_y| + |small_x small_y| + |r_x r_y|) per element, under
//     3 . 2^-22 sum |x_k y_k| <= 3 . 2^-22 S / 2; for the -2 x.y term:
//     12 u S.
//   * the tensor core's f32 accumulation over 3d exact tf32 products: taken
//     as truncating (error below 2u of the running sum per add), 3d adds,
//     sum|products| <= (1 + 2^-8) sum|x_k y_k|; for -2 x.y:
//     2 . 3d . 2u . (1 + 2^-8) S / 2 = 6d (1 + 2^-8) u S.
//   * the norms (f32 sums of d products): d u S; the epilogue's add and
//     subtract: 3 u S; sqrtf, squared again by the check: 4 u S.
//   So |D^2 - exact| <= (7d + 19 + 6d 2^-8) u S for this kernel.  The plain
//   version (f32 matmul and norms) is within (2d + 7) u S by the same count
//   with exact products, so against it
//       |dD^2| <= (9d + 26 + 6d 2^-8) 2^-24 (|x|^2 + |y|^2)
//   (chip_smoke.py: l2_sq_bound).  One TF32 product without the split would
//   add up to 2^-10 S, past this bound at every d.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (fused multiply-add allowed: parity is by
// tolerance, not bit-equality).  Only the CUDA runtime is linked.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BK = 32;      // floats per k-block: one 128-byte swizzle row
constexpr int MAX_GRID_Y = 65535;

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// one (32-float x rows) box of a 2-D f32 tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused in this
// layout.  The tile starts 1024-byte aligned; a k-step of 8 tf32 (32 bytes)
// adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128 f32, registers) += A (64 x 8) B (128 x 8)^T: A tf32 in
// registers (the m64k8 fragment), B in shared memory behind ``db``
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80 f32, registers) += A (64 x 8) B (80 x 8)^T: A tf32 in
// registers (the m64k8 fragment), B in shared memory behind ``db``
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n80(d, a, db);
  }
}

// byte offset of float (r, c), c < 32, in a 128-byte-swizzled K-major tile:
// the 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8), as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it and the descriptor reads it
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// -- the kernel ---------------------------------------------------------------

template <int NWG, int BN>
struct Tile {
  static constexpr int BM = 64 * NWG;          // rows: one warpgroup per 64
  static constexpr int THREADS = 128 * NWG;
  static constexpr int XB = BM * BK * 4;       // bytes of one x k-block
  static constexpr int YB = BN * BK * 4;       // bytes of one y k-block
  static constexpr int STAGE = XB + 2 * YB;    // x, y big (raw), y small
  static constexpr int STAGES = 4;             // ring of k-blocks
  static constexpr int YCH = BN * 8 / THREADS; // 16-byte y chunks a thread
  static constexpr int SMEM = 1024 + STAGES * STAGE + STAGES * 8 +
                              (BM + BN) * 4;
  static_assert(XB % 1024 == 0 && YB % 1024 == 0, "1024-byte tiles");
  static_assert(BN * 8 % THREADS == 0, "chunks");
};

// Stage layout: [x raw | y big | y small].  With TMA, y big first holds the
// raw f32 k-block; the split overwrites it.  x stays raw: each thread reads
// its A fragments from it and splits them in registers.
template <int NWG, int BN, bool TMA>
__global__ void __launch_bounds__(Tile<NWG, BN>::THREADS, 1)
pairwise_l2_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int M, int N, int d) {
  using TL = Tile<NWG, BN>;
  constexpr int BM = TL::BM, THREADS = TL::THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + TL::STAGES * TL::STAGE);
  float* xn = reinterpret_cast<float*>(bars + TL::STAGES);
  float* yn = xn + BM;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31, warp = (tid & 127) >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (d + BK - 1) / BK;
  // this thread's rows of the A fragment (and of the accumulator)
  const int ra = wg * 64 + warp * 16 + (lane >> 2);

  auto xraw = [&](int s) { return smem + s * TL::STAGE; };
  auto ybig = [&](int s) { return smem + s * TL::STAGE + TL::XB; };
  auto ysml = [&](int s) { return smem + s * TL::STAGE + TL::XB + TL::YB; };
  auto fill = [&](int kb) {  // thread 0: k-block kb into its stage
    const int s = kb % TL::STAGES;
    const uint32_t bar = smem_u32(bars + s);
    mbar_expect_tx(bar, TL::XB + TL::YB);
    tma_load(smem_u32(xraw(s)), &xmap, bar, kb * BK, m0);
    tma_load(smem_u32(ybig(s)), &ymap, bar, kb * BK, n0);
  };

  if (TMA && tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < TL::STAGES && kb < nk; ++kb) fill(kb);
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  float xna = 0.0f, xnb = 0.0f;  // |x|^2 partials of rows ra and ra + 8
  float ynorm[TL::YCH];
#pragma unroll
  for (int i = 0; i < TL::YCH; ++i) ynorm[i] = 0.0f;

  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % TL::STAGES;
    if (TMA) mbar_wait(smem_u32(bars + s), (kb / TL::STAGES) & 1);
    // y: split each 16-byte chunk in place (big over raw, small into the
    // twin), |y|^2 from the raw values
#pragma unroll
    for (int i = 0; i < TL::YCH; ++i) {
      const int q = tid + i * THREADS;  // physical chunk q % 8 of row q / 8
      const int r = q >> 3, pc = q & 7;
      const int off = r * 128 + pc * 16;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (TMA) {
        v = *reinterpret_cast<const float4*>(ybig(s) + off);
      } else {  // logical chunk pc ^ (r % 8): columns kb*BK + 4 (pc ^ r%8)
        const int gr = n0 + r, gc = kb * BK + 4 * (pc ^ (r & 7));
        if (gr < N) {
          const float* p = y + (size_t)gr * d + gc;
          if (gc < d) v.x = p[0];
          if (gc + 1 < d) v.y = p[1];
          if (gc + 2 < d) v.z = p[2];
          if (gc + 3 < d) v.w = p[3];
        }
      }
      float4 b, sm;
      b.x = tf32_rna(v.x);
      b.y = tf32_rna(v.y);
      b.z = tf32_rna(v.z);
      b.w = tf32_rna(v.w);
      sm.x = tf32_rna(v.x - b.x);
      sm.y = tf32_rna(v.y - b.y);
      sm.z = tf32_rna(v.z - b.z);
      sm.w = tf32_rna(v.w - b.w);
      ynorm[i] = fmaf(v.x, v.x, ynorm[i]);
      ynorm[i] = fmaf(v.y, v.y, ynorm[i]);
      ynorm[i] = fmaf(v.z, v.z, ynorm[i]);
      ynorm[i] = fmaf(v.w, v.w, ynorm[i]);
      *reinterpret_cast<float4*>(ybig(s) + off) = b;
      *reinterpret_cast<float4*>(ysml(s) + off) = sm;
    }
    // x: this thread's m64k8 A fragments of the 4 k-steps, split in
    // registers; register v holds row ra + 8 (v % 2), column t + 4 (v / 2)
    uint32_t fb[BK / 8][4], fs[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = ra + 8 * (v & 1);
        const int c = 8 * kk + (lane & 3) + 4 * (v >> 1);
        float a = 0.0f;
        if (TMA) {
          a = *reinterpret_cast<const float*>(xraw(s) + swz(r, c));
        } else if (m0 + r < M && kb * BK + c < d) {
          a = x[(size_t)(m0 + r) * d + kb * BK + c];
        }
        const float big = tf32_rna(a);
        fb[kk][v] = __float_as_uint(big);
        fs[kk][v] = __float_as_uint(tf32_rna(a - big));
        if (v & 1) {
          xnb = fmaf(a, a, xnb);
        } else {
          xna = fmaf(a, a, xna);
        }
      }
    }
    fence_proxy_async();  // the y split's stores, visible to wgmma
    __syncthreads();
    fence_regs(acc);
    wgmma_fence();
    const uint64_t bb = smem_desc(smem_u32(ybig(s)));
    const uint64_t bs = smem_desc(smem_u32(ysml(s)));
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_tile<BN>(acc, fb[kk], bs + 2 * kk);  // big . small
      wgmma_tile<BN>(acc, fs[kk], bb + 2 * kk);  // small . big
      wgmma_tile<BN>(acc, fb[kk], bb + 2 * kk);  // big . big
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // k-block kb - 1's products are done
    __syncthreads();  // ... in every warpgroup: its stage is free
    if (TMA && tid == 0 && kb >= 1 && kb - 1 + TL::STAGES < nk) {
      fence_proxy_async();
      fill(kb - 1 + TL::STAGES);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // row norms: x over the 4 lanes of a quad, y over the 8 threads of a row
  xna += __shfl_xor_sync(0xffffffffu, xna, 1);
  xna += __shfl_xor_sync(0xffffffffu, xna, 2);
  xnb += __shfl_xor_sync(0xffffffffu, xnb, 1);
  xnb += __shfl_xor_sync(0xffffffffu, xnb, 2);
  if ((lane & 3) == 0) {
    xn[ra] = xna;
    xn[ra + 8] = xnb;
  }
#pragma unroll
  for (int i = 0; i < TL::YCH; ++i) {
    float v = ynorm[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if ((tid & 7) == 0) yn[(tid + i * THREADS) >> 3] = v;
  }
  __syncthreads();

  // accumulator layout of m64nNk8: register 4j + 2h + e holds row ra + 8h,
  // column 8j + 2 (lane % 4) + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const int gr = m0 + r;
    if (gr >= M) continue;
    float* row = out + (size_t)gr * (size_t)N;
    const float nx = xn[r];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + e;
        const int gc = n0 + c;
        if (gc < N) {
          const float d2 = nx + yn[c] - 2.0f * acc[4 * j + 2 * h + e];
          row[gc] = sqrtf(fmaxf(d2, 0.0f));
        }
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, d) f32 row-major as boxes of 32 floats x box_rows, 128-byte swizzle,
// zeros out of bounds
int make_map(CUtensorMap* map, const float* base, int rows, int d,
             int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<float*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NWG, int BN, bool TMA>
int launch(const float* x, const float* y, float* out, int M, int N, int d,
           cudaStream_t stream) {
  using TL = Tile<NWG, BN>;
  const int grid_y = (M + TL::BM - 1) / TL::BM;
  if (grid_y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xmap, ymap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&ymap, 0, sizeof(ymap));
  if (TMA) {
    int rc = make_map(&xmap, x, M, d, TL::BM);
    if (rc == 0) rc = make_map(&ymap, y, N, d, BN);
    if (rc) return rc;
  }
  auto kern = pairwise_l2_kernel<NWG, BN, TMA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, grid_y);
  kern<<<grid, TL::THREADS, TL::SMEM, stream>>>(xmap, ymap, x, y, out, M, N,
                                                 d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one (M, N) distance matrix on ``stream``; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for an empty or
// negative shape, cudaErrorInvalidConfiguration when M needs more than
// 65535 row tiles.  ``plan`` receives the choice: bit 0 set for the TMA
// loader (else the plain one), bit 1 set for 128 x 128 tiles (else 64 x
// 80).  Asynchronous: nothing is synchronised.
int pairwise_l2_launch(const float* x, const float* y, float* out, int M,
                       int N, int d, int device, void* stream, int* plan) {
  if (M < 1 || N < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool tma = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long big_tiles = (long)((M + 127) / 128) * ((N + 127) / 128);
  const bool big = big_tiles >= 2L * sms;
  *plan = (tma ? 1 : 0) | (big ? 2 : 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (big)
    return tma ? launch<2, 128, true>(x, y, out, M, N, d, st)
               : launch<2, 128, false>(x, y, out, M, N, d, st);
  return tma ? launch<1, 80, true>(x, y, out, M, N, d, st)
             : launch<1, 80, false>(x, y, out, M, N, d, st);
}

// Dynamic shared memory of one block of the tile that ``plan`` names.
int pairwise_l2_smem_bytes(int plan) {
  return (plan & 2) ? Tile<2, 128>::SMEM : Tile<1, 80>::SMEM;
}

const char* pairwise_l2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
