// K6, the attention forward of prefill: causal or sliding-window online-softmax attention
//
//   out[b, i, h] = sum_j softmax_j(mask(q[b, i, h] . k[b, j, h/G] * dh^-1/2)) v[b, j, h/G]
//   mask: j < S, and j <= i when causal, and i - j < window when a window is given
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_kernel / flash_attention_pallas (:25, :69), which the JAX model's
// chunked_attention (src/repro/models/transformer.py:180) computes in plain jnp.  Operands
// are bf16 in the model's (B, S, H, dh) layout, read through their strides (no transpose,
// no head repeat: query head h reads KV head h / G); scores, the running max and sum and the
// accumulator are float32; the output is bf16, rounded to nearest.  Any S: the ragged edge
// is masked (the TPU kernel asserts S % block == 0); dh a multiple of 16 up to 256.
//
// Bound: operations.  4 * dh flops for every unmasked (query, key) pair against 2 bytes for
// each element of q, k, v and out: at gemma3-1b's prefill_32k (dh = 256, G = 4, S = 32,768)
// a global layer needs 4.4 TFLOP for 0.34 GB, about 13,000 flops a byte, far past the
// card's 295 for bf16.  So both products run on the tensor cores through Hopper's wgmma,
// fed by TMA, in FlashAttention-3's shape:
//
// - A block of three warpgroups owns 128 query rows of one (sequence, head).  Warpgroup 0
//   is the producer: one thread issues every TMA load and the rest idle; setmaxnreg gives
//   it 24 registers a thread so that the two consumer warpgroups get 240 (128 * 24 +
//   256 * 240 <= 65,536).  Each consumer warpgroup owns 64 query rows.
// - Loads: one 4-D tensor map each for q, k and v over (dh, H, S, B) with the tensors' own
//   byte strides, built on the host by cuTensorMapEncodeTiled (reached through the runtime's
//   driver entry point, so nothing links against libcuda).  128-byte swizzle caps a box at
//   64 bf16 columns, so a row of dh arrives as dh / 64 boxes, each a (rows x 64) tile whose
//   8-row groups are 1,024 bytes.  TMA zero-fills what lies outside the tensor: columns
//   past dh (dh = 80 runs in the 128 instantiation) and positions past S (never the next
//   sequence, which is another coordinate).  Zero keys are not masked keys: the j < S test
//   below still masks their scores.
// - q is loaded once.  K and V tiles of BK rows go through two rings of kStages = 2 stages,
//   each stage with a "full" barrier (the producer's expect_tx, completed by TMA's bytes)
//   and an "empty" barrier (one arrival from each of the 8 consumer warps).  K and V have
//   rings of their own because a consumer frees K(t) one step before V(t).  Every block
//   counts its tiles from 0, so the barriers' phase bits do not depend on which tiles it
//   skips.
// - S = Q K^T is wgmma m64nBKk16 with both operands K-major from swizzled shared memory
//   (descriptors: 128-byte swizzle, stride byte offset 1,024; a 16-column step moves the
//   start address 32 bytes inside the swizzle atom, a 64-column step moves to the next box).
//   O += P V is wgmma m64n{dh}k16 with P in registers: the score accumulator's fragment is
//   the A operand's layout, so P is converted to bf16 in place.  V is the MN-major B
//   operand (the transpose bit; leading byte offset = one box, from 64 columns of dh to the
//   next; stride byte offset 1,024 between 8-row groups of keys).
// - Within a warpgroup, tile t's Q K^T is issued before tile t - 1's P V, and the softmax
//   of tile t runs while P V still computes (wgmma commit groups, wait_group 1 then 0).
// - Budget at dh = 256: q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB of the 227 KB a
//   block may have, one block an SM, BK = 64.  A consumer thread holds its warpgroup's
//   64 x 256 float32 accumulator (128 registers), the 64 x 64 score tile (32), P as bf16
//   (16) and the row statistics, within 240.  BK = 128, or a third stage, would need 256 KB
//   of shared memory.  At dh <= 128, BK = 128: q 32 KB + 128 KB of stages, 64 + 64
//   registers for the accumulator and scores.
//
// Tiles wholly past the diagonal are skipped, and with a window so are tiles wholly before
// q_lo - window + 1: a local layer (window 512) at 32 K walks about 10 tiles of 64 keys.
// Blocks start with the longest rows.  The per-element mask runs only on edge tiles, a
// warp-uniform test.
//
// Numerics: the scale is folded with log2(e) and multiplies the float32 product; the
// softmax uses exp2f; masked scores are -1e30 and their probabilities exactly 0; the output
// is acc / max(l, 1e-30).  P enters the second product as bf16, where the plain version
// keeps it in float32: outputs agree to a bf16 tolerance, not to the bit.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int BQ = 64 * kConsumers;            // query rows of a block
constexpr int kStages = 2;                     // K and V ring depth
constexpr int kBoxCols = 64;                   // bf16 columns in a 128-byte swizzled row
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kMasked = -1e30f;

struct Params {
  bf16* o;
  int64_t ob, os, oh;  // output strides, in elements
  int S, Hq, G, dh;
  int causal, window;  // window <= 0: none
  float scale_log2;    // dh^-1/2 * log2(e)
};

template <int DHP>
struct Cfg {
  static constexpr int BK = DHP > 128 ? 64 : 128;  // KV rows a step
  static constexpr int kChunks = DHP / kBoxCols;    // boxes across dh
  static constexpr int kQBox = 64 * 128;            // bytes of one (64 rows x 64 columns) box
  static constexpr int kKVBox = BK * 128;
  static constexpr int kQBytes = kConsumers * kChunks * kQBox;
  static constexpr int kKVBytes = kChunks * kKVBox;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // tiles, 1 + 4 * kStages barriers, and slack to align the base to the 1,024-byte atom
  static constexpr int kSmem = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The producer's arrival, announcing the bytes that TMA will complete the phase with.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of the given parity has completed.  (No timeout: a clock64 test in
// this loop made ptxas ignore setmaxnreg and spill at dh = 128 and 256.)
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
// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled tile (layout type 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an asynchronous wgmma writes: reads of them stay after the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(b)                                                                                  \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 64) = A B + (scale_d ? d : 0); A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128) = A B + (scale_d ? d : 0); A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A B; A (64 x 16) from registers, B from shared memory, MN-major (the
// transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A B; A (64 x 16) from registers, B from shared memory, MN-major (the
// transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256) += A B; A (64 x 16) from registers, B from shared memory, MN-major (the
// transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

// Two floats as a bf16 pair, lo in the low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scale and mask one score tile of a warp's rows row0 + g and row0 + g + 8 (accumulator
// element 4 n + e sits on row g + 8 (e >> 1), column 8 n + 2 t4 + (e & 1)), update the
// running max m and sum l, and turn the scores into probabilities in place; alpha gets
// the factor that rescales the rows' accumulator.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p, int kv0,
                                             int row0, int g, int t4) {
  const bool full = kv0 + BK <= p.S && (!p.causal || kv0 + BK - 1 <= row0) &&
                    (p.window <= 0 || row0 + 15 - kv0 < p.window);
  float mx[2] = {m[0], m[1]};
  if (full) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] *= p.scale_log2;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = row0 + g + 8 * ((i >> 1) & 1), c = kv0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool ok =
          c < p.S && (!p.causal || c <= r) && (p.window <= 0 || r - c < p.window);
      s[i] = ok ? s[i] * p.scale_log2 : kMasked;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float pv = full || s[i] != kMasked ? exp2f(s[i] - m[r]) : 0.f;
    s[i] = pv;
    l[r] += pv;
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<DHP>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;  // the swizzle atom's alignment
  const uint32_t sK = sQ + C::kQBytes, sV = sK + kStages * C::kKVBytes;
  const uint32_t bar_q = sQ + C::kBarOffset;
  // per stage: K full, K empty, V full, V empty
  auto bar = [&](int kind, int stage) { return bar_q + 8 * (1 + 4 * stage + kind); };

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / p.G;
  const int q_hi = min(q_lo + BQ, p.S) - 1;
  const int kv_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int kv_end = p.causal ? q_hi + 1 : p.S;
  const int t_begin = kv_begin / BK, n_tiles = (kv_end + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 4 * kConsumers);
      mbar_init(bar(2, s), 1);
      mbar_init(bar(3, s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load(sQ + (c * C::kChunks + ch) * C::kQBox, &tq, bar_q, ch * kBoxCols, h,
                   q_lo + 64 * c, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kv0 = (t_begin + i) * BK;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;  // the first round passes
        mbar_wait(bar(1, s), free_parity);
        mbar_expect_tx(bar(0, s), C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load(sK + s * C::kKVBytes + ch * C::kKVBox, &tk, bar(0, s), ch * kBoxCols, hk, kv0,
                   b);
        }
        mbar_wait(bar(3, s), free_parity);
        mbar_expect_tx(bar(2, s), C::kKVBytes);
#pragma unroll
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load(sV + s * C::kKVBytes + ch * C::kKVBox, &tv, bar(2, s), ch * kBoxCols, hk, kv0,
                   b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, 16 a warp
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q_lo + 64 * c + 16 * warp;  // the warp's first query row
  const uint64_t q_desc = sw128_desc(sQ + c * C::kChunks * C::kQBox, 16, 1024);

  float o[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];  // P in bf16, the A operand of each 16-key step of P V
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, alpha[2];

  auto issue_qk = [&](int st) {  // s = Q K^T over the K tile in stage st
    const uint64_t k_desc = sw128_desc(sK + st * C::kKVBytes, 16, 1024);
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch) {
#pragma unroll
      for (int kk = 0; kk < kBoxCols / 16; ++kk) {
        wgmma_ss(s, q_desc + ((ch * C::kQBox + kk * 32) >> 4),
                 k_desc + ((ch * C::kKVBox + kk * 32) >> 4), ch + kk > 0);
      }
    }
  };
  auto issue_pv = [&](int st) {  // o += P V over the V tile in stage st
    const uint64_t v_desc = sw128_desc(sV + st * C::kKVBytes, C::kKVBox, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(o, pa[kk], v_desc + ((kk * 16 * 128) >> 4));
  };
  auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
  };
  auto release = [&](int kind, int st) {
    if (lane == 0) mbar_arrive(bar(kind, st));
  };

  mbar_wait(bar_q, 0);
  mbar_wait(bar(0, 0), 0);
  wg_fence();
  issue_qk(0);
  wg_commit();
  wg_wait<0>();
  pin(s);
  release(1, 0);
  softmax_tile<BK>(s, m, l, alpha, p, t_begin * BK, row0, g, t4);
  to_bf16();
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % kStages, prev = (i - 1) % kStages;
    mbar_wait(bar(0, st), (i / kStages) & 1);
    wg_fence();
    issue_qk(st);  // tile i's scores ...
    wg_commit();
    mbar_wait(bar(2, prev), ((i - 1) / kStages) & 1);
    issue_pv(prev);  // ... while tile i - 1's P V computes
    wg_commit();
    wg_wait<1>();
    pin(s);
    release(1, st);
    softmax_tile<BK>(s, m, l, alpha, p, (t_begin + i) * BK, row0, g, t4);
    wg_wait<0>();
    pin(o);
    release(3, prev);
#pragma unroll
    for (int j = 0; j < DHP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
    to_bf16();
  }
  const int last = (n_tiles - 1) % kStages;
  mbar_wait(bar(2, last), ((n_tiles - 1) / kStages) & 1);
  wg_fence();
  issue_pv(last);
  wg_commit();
  wg_wait<0>();
  pin(o);

  // out = acc / max(l, 1e-30), rounded to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= p.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = p.o + b * p.ob + static_cast<int64_t>(row) * p.os + h * p.oh;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.dh) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
      }
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

// A (B, S, H, dh) bf16 operand with element strides sb, ss, sh as a map over (dh, H, S, B)
// whose box is `rows` positions x 64 columns of one head, 128-byte swizzled; what lies
// past S or dh reads as zeros.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int dh, int64_t sb,
                  int64_t ss, int64_t sh, int rows) {
  // a dimension of extent 1 is never stepped along: give it a packed layout's stride
  if (H == 1) sh = dh;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Operands {
  const void *q, *k, *v;
  int B, Hkv;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// A failed tensor-map encoding returns minus its CUresult.
template <int DHP>
int launch(const Operands& a, const Params& p, cudaStream_t stream) {
  using C = Cfg<DHP>;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, a.q, a.B, p.S, p.Hq, p.dh, a.qb, a.qs, a.qh, 64);
  if (r == CUDA_SUCCESS) r = make_map(&tk, a.k, a.B, p.S, a.Hkv, p.dh, a.kb, a.ks, a.kh, C::BK);
  if (r == CUDA_SUCCESS) r = make_map(&tv, a.v, a.B, p.S, a.Hkv, p.dh, a.vb, a.vs, a.vh, C::BK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, a.B * p.Hq);
  flash_fwd_kernel<DHP><<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, dh), k and v (B, S, Hkv, dh), out (B, S, Hq, dh), all bf16 with unit stride on
// dh and the other strides (elements) as given, multiples of 8, pointers 16-byte aligned.
// window <= 0: none.  Launches on `stream`; returns 0 on success, a CUDA runtime error
// code, or minus a driver error code where a tensor map could not be encoded.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int Hq, int Hkv, int dh,
                                   int64_t qb, int64_t qs, int64_t qh,
                                   int64_t kb, int64_t ks, int64_t kh,
                                   int64_t vb, int64_t vs, int64_t vh,
                                   int64_t ob, int64_t os, int64_t oh,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dh <= 0 || dh % 16 != 0 || dh > 256 ||
      static_cast<int64_t>(B) * Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Operands a{q, k, v, B, Hkv, qb, qs, qh, kb, ks, kh, vb, vs, vh};
  const Params p{static_cast<bf16*>(out), ob, os, oh, S, Hq, Hq / Hkv, dh, causal != 0, window,
                 scale * 1.4426950408889634f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch<64>(a, p, s);
  if (dh <= 128) return launch<128>(a, p, s);
  return launch<256>(a, p, s);
}

// Dynamic shared memory of one block of the instantiation that runs head width dh, in bytes
// (ptxas does not see it); 0 for a dh the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dh) {
  if (dh <= 0 || dh % 16 != 0 || dh > 256) return 0;
  if (dh <= 64) return Cfg<64>::kSmem;
  if (dh <= 128) return Cfg<128>::kSmem;
  return Cfg<256>::kSmem;
}
