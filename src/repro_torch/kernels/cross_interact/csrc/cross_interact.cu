// K5, the fused DCN-v2 cross layer:
//
//   out = x0 * (x @ w + b) + x        x0, x (B, D); w (D, D) taken as x @ w; b (D,)
//
// Replaces the TPU kernel src/repro/kernels/cross_interact/kernel.py,
// cross_interact_kernel / cross_interact_pallas (:18, :28).  Same contract: float32
// operands, all contiguous, out (B, D) float32.  As on the TPU, the point is the fused
// epilogue: the (B, D) product never reaches device memory; each output is written once.
// Unlike the TPU kernel, nothing is padded to a block of rows: blocks mask both ragged
// edges (the DCN-v2 width D = 429 = 3 * 11 * 13 divides no tile).
//
// Bound: operations.  2 * B * D^2 multiply-add operations against 4 * (3 * B * D + D^2 + D)
// bytes: at D = 429 about 71 operations a byte.  Past the card's 20 for float32 outside the
// tensor cores, so the product runs on the tensor cores (Hopper's wgmma, tf32 operands).
//
// Numerics: 3xTF32.  The TPU kernel multiplies at Precision.DEFAULT, but the port is held to
// float32: rtol = atol = 1e-4 against the float32 plain version.  One tf32 pass (10 mantissa
// bits) misses that by up to 40x on seeded operands (max |err| 3e-3 to 4e-3 at D = 429).  So
// each operand is split into two tf32 parts with cvt.rna (round to nearest, ties away):
// a_big = tf32(a), a_small = tf32(a - a_big), and the kernel accumulates
// x_small W_big + x_big W_small + x_big W_big in wgmma's float32 accumulator, the small
// products first in each k step.  x_small W_small is dropped: big + small holds an operand to
// 2^-22 of itself, so the products err by about 2^-21 relative, like float32's own rounding
// of the sums.  Three tensor-core passes run at 495 / 3 = 165 TFLOP/s of float32-accurate
// work, 2.5x the 67 of the SIMT cores.  Built without fast-math: a - a_big must not be
// reassociated.
//
// Design:
// - A prep kernel runs first on every call: it writes W^T's big and small halves into a
//   scratch (2, D, Kp) tensor, Kp = D rounded up to 32, zeros past D.  wgmma takes tf32
//   operands K-major only, and w as x @ w is N-major.  Nothing is cached across calls: a
//   weight changed in place must not give a stale answer.  Within each 32-wide k slice the
//   prep also permutes k (below), so that the x fragments load as 16-byte vectors.
// - W^T: TMA (a 3-D tensor map over (Kp, D, half), box 32 k x BN rows, 128-byte swizzle)
//   into a ring of kStages stages with full/empty mbarriers.  A producer warpgroup (one
//   thread issues the loads; setmaxnreg gives it 24 registers) feeds two consumer
//   warpgroups (240 registers each), as in K6 (flash_attention.cu).
// - x: a row is D * 4 = 1,716 bytes at D = 429, not a multiple of 16, so TMA cannot read
//   it.  Each consumer warpgroup stages its own 64 x 32 slice of x into shared memory with
//   coalesced 4-byte cp.async (zero-filled past B and D: the zero k rows of W^T must not
//   meet a neighbouring row's Inf), kStages - 1 slices ahead.  Each thread then reads its
//   fragment as 16-byte vectors, splits it in registers and issues the register-A form of
//   wgmma m64nBNk8 .tf32.  No split copy of x is ever written to memory.
// - k order: wgmma's A fragment gives thread (g, t4) of a warp the logical columns t4 and
//   t4 + 4 of each k8 step.  The kernel maps logical (step j, column t4 + 4h) to physical
//   column 8 t4 + 2 j + h of the slice, so a thread's 16 values of a 32-wide slice are 8
//   contiguous columns of two rows.  The prep stores W^T's slice in the same order.
// - Tiles: BM = 128 rows (64 per consumer), BN = 216 columns (two column tiles at
//   D = 429), BK = 32 (four k8 steps, one 128-byte swizzled row of W^T), kStages = 3 of
//   72 KB.  The accumulator is 108 registers a thread.  Blocks are persistent, one an SM,
//   and walk the tiles in row-major order, so the two column tiles of one row tile run side
//   by side and x is read from device memory once and from L2 after that.  The next tile's
//   W and x loads are in flight during a tile's epilogue; odd blocks start 10 us late, so
//   that neighbouring blocks' epilogues do not coincide (below).  tools/k5_variants.py
//   times the choices on the card: on an H100 SXM (700 W) at serve_bulk's shape
//   (B = 262,144) BN = 216 took 1.19 ms against 1.43-1.44 for BN = 144 (three column tiles,
//   four stages); at B = 512 and 1, BN = 144 was 11-16 % faster.
// - Epilogue: the warp stages its accumulator 32 columns at a time in shared memory, so
//   that lane l reads b, x0 and x at column l down the warp's 16 rows (each load and store
//   of the warp covers 32 neighbouring floats of one row), masks the ragged edges and
//   writes x0 * (acc + b) + x once.
// - What holds it back (the same script, same card): the phases overlap little.  Fed by W
//   alone the three passes take 0.68 ms, 86 % of the tensor cores' peak; staging x through
//   shared memory adds 0.22 ms (probably shared-memory bandwidth, most of which the wgmma
//   B reads take); the epilogue's loads and stores add 0.29 ms with the tensor cores idle.
//
// The products' sums run in another order than a CPU GEMM's, and the tensor cores add in
// their own way: results agree with the float32 plain version to a tolerance, not to the bit.
// The adds cost more than the split: chip_smoke.py finds a worst |err| / limit of 0.24
// over its edge shapes (B up to 4,099), 0.46 on seeded standard-normal operands at
// 262,144 x 429 and 0.015-0.02 on serve_bulk's layers, where a float64 sum of the same
// tf32 products (ref.cross_interact_tf32_model) stays near 0.03 at (512, 429).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 2;                 // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int BM = 64 * kConsumers;           // rows of a tile
constexpr int BN = 216;                       // columns of a tile: two at D = 429
constexpr int BK = 32;                        // k of a stage: 128 bytes of tf32
constexpr int kXPitch = BK + 4;  // floats per staged x row: 16-byte rows, no bank conflicts
constexpr int kWHalf = BN * BK * 4;           // bytes of one half (big or small) of W^T
constexpr int kWStage = 2 * kWHalf;
constexpr int kXStage = kConsumers * 64 * kXPitch * 4;
constexpr int kChunks = (BN + 31) / 32;       // 32-column chunks of the epilogue
constexpr int kStages = 3;                    // 3 x 72 KB of the 227 KB a block may have
constexpr int kSmem = kStages * (kWStage + kXStage) + 16 * kStages + 1024;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr long long kStaggerCycles = 18000;   // about 10 us at the H100's 1.8 GHz
static_assert(kWHalf % 1024 == 0, "a W^T half must keep the swizzle atom's alignment");
static_assert(kStages >= 2 && kSmem <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- the prep kernel: W^T's tf32 halves, k permuted within each 32-wide slice ----------

// Stored position p = 8 j + kk of a slice holds physical k 8 (kk & 3) + 2 j + (kk >> 2).
__global__ void __launch_bounds__(256)
    prep_kernel(const float* __restrict__ w, float* __restrict__ wt, int D, int Kp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // coalesced along n
    const int k = k0 + ty + 8 * i, n = n0 + tx;
    tile[ty + 8 * i][tx] = k < D && n < D ? w[static_cast<int64_t>(k) * D + n] : 0.f;
  }
  __syncthreads();
  const int q = 8 * (tx & 3) + 2 * (tx >> 3) + ((tx >> 2) & 1);
  const int64_t half = static_cast<int64_t>(D) * Kp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // coalesced along k
    const int n = n0 + ty + 8 * i;
    if (n >= D) continue;
    const float v = tile[q][ty + 8 * i];
    const uint32_t big = tf32_rna(v);
    const int64_t o = static_cast<int64_t>(n) * Kp + k0 + tx;
    wt[o] = __uint_as_float(big);
    wt[half + o] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
  }
}

// ---- mbarriers, TMA, cp.async ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of the given parity has completed (no timeout: see K6).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// 4 bytes from global to shared memory; zeros where `n` is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma ------------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled K-major tile (layout type 1):
// stride byte offset 1,024 between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that an asynchronous wgmma reads or writes: uses stay after the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3])
#define F8(b) F4(b), F4(b + 4)
static_assert(BN == 216, "wgmma_tf32 is written out for n = 216");

// d (64 x 216) += A B: A (64 x 8) tf32 from registers, B (216 x 8) tf32 from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32(float (&d)[108], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %113, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n216k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107"
      "}, {%108, %109, %110, %111}, %112, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80),
        F8(88), F8(96), F4(104)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8
#undef F4

// ---- the main kernel --------------------------------------------------------------------

struct Args {
  const float* x0;
  const float* x;
  const float* b;
  float* out;
  int64_t B;
  int64_t n_tiles;
  int D, n_col_tiles;
};

__global__ void __launch_bounds__(kThreads, 1)
    cross_kernel(const __grid_constant__ CUtensorMap tw, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sW = (smem_u32(smem) + 1023) & ~1023u;  // the swizzle atom's alignment
  const uint32_t sX = sW + kStages * kWStage;
  const uint32_t bar0 = sX + kStages * kXStage;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  const int KT = (a.D + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: W^T's two halves of every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int64_t t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
        const int n0 = static_cast<int>(t % a.n_col_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full(s), kWStage);
          tma_load(sW + s * kWStage, &tw, full(s), kt * BK, n0, 0);
          tma_load(sW + s * kWStage + kWHalf, &tw, full(s), kt * BK, n0, 1);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of each tile, 16 a warp
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t sXc = sX + c * (64 * kXPitch * 4);
  // the warp's 16 rows of the consumer's x slice in stage 0
  float* const xw =
      reinterpret_cast<float*>(smem + (sXc - smem_u32(smem))) + 16 * warp * kXPitch;

  // Stage this block's step `step` (tile step / KT, k slice step % KT) of x: lane = column,
  // warp w the rows w, w + 4, ..., w + 60.  Always commits a group, empty past the last tile.
  auto issue_x = [&](int step) {
    const int64_t t = blockIdx.x + static_cast<int64_t>(step / KT) * gridDim.x;
    if (t < a.n_tiles) {
      const int col = (step % KT) * BK + lane;
      const int64_t row0 = (t / a.n_col_tiles) * BM + 64 * c + warp;
      const uint32_t dst = sXc + (step % kStages) * kXStage + (warp * kXPitch + lane) * 4;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int64_t r = row0 + 4 * i;
        const bool ok = r < a.B && col < a.D;
        cp_async4(dst + i * (4 * kXPitch * 4), ok ? a.x + r * a.D + col : a.x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  int step = 0;  // this block's (tile, k slice) steps so far, as the producer counts them
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue_x(s);

  if ((blockIdx.x & 1) && a.n_col_tiles % 2 == 0 && gridDim.x % 2 == 0 &&
      a.n_tiles >= 2 * static_cast<int64_t>(gridDim.x)) {
    // With an even grid and an even number of column tiles (both hold at D = 429 on 132
    // SMs), odd blocks take only odd column tiles, so the neighbour to their left shares
    // their row tiles.  They start about 10 us after it: they then find x in L2, and their
    // epilogue falls in the neighbour's main loop: 1.26-1.27 -> 1.19 ms at serve_bulk's
    // shape (tools/k5_variants.py, H100 SXM, 700 W).  A grid that gives no block two tiles
    // (B below about 17,000 at D = 429) does not wait.
    const long long t0 = clock64();
    while (clock64() - t0 < kStaggerCycles) __nanosleep(200);
  }
  float acc[BN / 2];
  int pending = -1;  // the stage whose products were issued last and not yet waited for
  for (int64_t t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++step) {
      const int st = step % kStages;
      cp_async_wait<kStages - 2>();  // this thread's part of slice `step` has landed ...
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");  // ... and everyone's
      issue_x(step + kStages - 1);  // into the buffer that every thread has read
      // rows g and g + 8 of the warp's 16, physical columns 8 t4 .. 8 t4 + 7
      float raw[16];
      const float* xp = xw + st * (kXStage / 4) + g * kXPitch + 8 * t4;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        *reinterpret_cast<float4*>(raw + 4 * v) =
            *reinterpret_cast<const float4*>(xp + (v >> 1) * 8 * kXPitch + (v & 1) * 4);
      }
      wg_wait0();  // the previous step's products are done with their registers and stage
      pin(raw);
      if (pending >= 0 && lane == 0) mbar_arrive(empty(pending));
      // a (step j) = rows g, g + 8 at logical column t4, then at t4 + 4
      uint32_t big[4][4], small[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v[4] = {raw[2 * j], raw[8 + 2 * j], raw[2 * j + 1], raw[8 + 2 * j + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          big[j][e] = tf32_rna(v[e]);
          small[j][e] = tf32_rna(v[e] - __uint_as_float(big[j][e]));
        }
      }
      mbar_wait(full(st), (step / kStages) & 1);
      const uint64_t wb = sw128_desc(sW + st * kWStage);
      const uint64_t ws = sw128_desc(sW + st * kWStage + kWHalf);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a k8 step is 32 bytes into the swizzled row
        wgmma_tf32(acc, small[j], wb + 2 * j);
        wgmma_tf32(acc, big[j], ws + 2 * j);
        wgmma_tf32(acc, big[j], wb + 2 * j);
      }
      wg_commit();
      pending = st;
    }
    wg_wait0();
    pin(acc);
    if (lane == 0) mbar_arrive(empty(pending));
    const int st_last = pending;
    pending = -1;

    // out = x0 * (acc + b) + x, 32 columns at a time through the warp's 16 rows of the x
    // slice just read (the next write into it follows the next step's barrier).  Element
    // 4 n + e of acc sits on row g + 8 (e >> 1), column 8 n + 2 t4 + (e & 1) of the warp's
    // 16 x BN block; there lane l takes column l of a chunk down the 16 rows, so each load
    // and store of the warp covers 32 neighbouring floats of one row.  out never aliases x0
    // or x (the wrapper allocates it), so the 32 loads of a lane go out together.
    float* const sa = xw + st_last * (kXStage / 4);
    const int64_t rw = (t / a.n_col_tiles) * BM + 64 * c + 16 * warp;
    const int cb = static_cast<int>(t % a.n_col_tiles) * BN;
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int n = 4 * m + nn;
        if (n < BN / 8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sa[(g + 8 * (e >> 1)) * kXPitch + 8 * nn + 2 * t4 + (e & 1)] = acc[4 * n + e];
          }
        }
      }
      __syncwarp();
      const int col = cb + 32 * m + lane;
      if (32 * m + lane < BN && col < a.D) {
        float v0[16], v1[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {  // every load before the first store
          const int64_t o = (rw + r < a.B ? rw + r : 0) * a.D + col;
          v0[r] = __ldg(a.x0 + o);
          v1[r] = __ldg(a.x + o);
        }
        const float bc = __ldg(a.b + col);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (rw + r < a.B) {
            a.out[(rw + r) * a.D + col] = fmaf(v0[r], sa[r * kXPitch + lane] + bc, v1[r]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

int kpad(int D) { return (D + BK - 1) / BK * BK; }

}  // namespace

// W^T's tf32 halves of w (D, D) into wt (2, D, Kp), Kp = D rounded up to 32, as the main
// kernel reads them.  Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cross_interact_prep(const void* w, void* wt, int D, void* stream) {
  if (D <= 0) return 0;
  const int Kp = kpad(D);
  const dim3 grid(Kp / 32, (D + 31) / 32);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), D, Kp);
  return static_cast<int>(cudaGetLastError());
}

// out = x0 * (x @ w + b) + x from wt as cross_interact_prep wrote it.  Launches on
// `stream`; returns 0 on success, a CUDA runtime error code, or minus a driver error code
// where the tensor map could not be encoded.
extern "C" int cross_interact(const void* x0, const void* x, const void* wt, const void* b,
                              void* out, int64_t B, int D, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int Kp = kpad(D);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(D), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp) * 4,
                                 static_cast<cuuint64_t>(D) * Kp * 4};
  const cuuint32_t box[3] = {BK, BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap tw;
  const CUresult r = encode_tiled()(
      &tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(wt), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      cudaFuncSetAttribute(cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_col_tiles = (D + BN - 1) / BN;
  const Args a{static_cast<const float*>(x0), static_cast<const float*>(x),
               static_cast<const float*>(b), static_cast<float*>(out), B,
               (B + BM - 1) / BM * n_col_tiles, D, n_col_tiles};
  const int64_t grid = a.n_tiles < sms ? a.n_tiles : sms;
  cross_kernel<<<static_cast<unsigned>(grid), kThreads, kSmem,
                 static_cast<cudaStream_t>(stream)>>>(tw, a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block of the main kernel, in bytes (ptxas does not see it).
extern "C" int cross_interact_smem_bytes() { return kSmem; }
