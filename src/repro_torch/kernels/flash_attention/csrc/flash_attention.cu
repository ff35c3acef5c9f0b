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
// card's 295 for bf16.  So the products go through the tensor cores: mma.sync m16n8k16,
// bf16 in, float32 accumulate.  Design (FlashAttention-2's, kept simple): a block of 4
// warps owns 64 query rows of one (sequence, head), 16 rows a warp.  It stages its q tile
// in shared memory once and walks the KV tiles (64 rows, 32 at dh = 256) through two
// shared buffers filled with 16-byte cp.async, the next tile in flight while the current
// one is used.  A warp takes S = Q K^T from ldmatrix fragments, scales and masks it, updates
// its rows' max and sum, packs P to bf16 in registers as the A operand of O += P V (V read
// with ldmatrix.trans) and rescales its float32 accumulator.  Tiles past the diagonal and,
// with a window, tiles wholly before q_lo - window + 1 are skipped: on a local layer
// (window 512) at 32K that is 64x less work than causal.  Blocks start with the longest
// rows.  At dh = 256 a warp's 16 x 256 accumulator is 128 registers a thread; the 32-row
// KV tile keeps the score tile at 16.  Shared rows are padded by 16 bytes so ldmatrix's
// eight rows fall in eight different bank groups.  Still simple: no wgmma, no TMA, no
// warp specialisation.
//
// Numerics: the scale multiplies the float32 product (as chunked_attention does), expf
// (not __expf), masked scores are -1e30 and their probabilities exactly 0, the output is
// acc / max(l, 1e-30).  P enters the second product as bf16, where the plain version keeps
// it in float32: outputs agree to a bf16 tolerance, not to the bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = kWarps * 16;  // query rows of a block
constexpr float kMasked = -1e30f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int64_t qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;  // strides, in elements
  int S, Hq, G, dh;
  int causal, window;  // window <= 0: none
  float scale;
};

template <int DHP>
struct Tile {
  static constexpr int BK = DHP > 128 ? 32 : 64;  // KV rows a step
  static constexpr int LDS = DHP + 8;             // shared row stride (elements)
  static constexpr int kSmem = (BQ + 4 * BK) * LDS * 2;  // q + two K and two V buffers
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ROWS x DHP tile from `base` (row stride rs) into shared memory; rows >= nrows and
// columns >= dh are zero-filled.
template <int ROWS, int DHP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int64_t rs, int nrows,
                                          int dh) {
  constexpr int kChunks = DHP / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "a tile is whole rounds of 16-byte chunks");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < nrows && c < dh;
    cp_async16(dst + r * Tile<DHP>::LDS + c, ok ? base + r * rs + c : base, ok);
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int BK = Tile<DHP>::BK, LDS = Tile<DHP>::LDS;
  constexpr int NT = BK / 8;   // score n-tiles of a warp
  constexpr int DT = DHP / 8;  // accumulator n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDS;   // two buffers of BK rows
  bf16* sV = sK + 2 * BK * LDS;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / p.G;
  const int q_hi = min(q_lo + BQ, p.S) - 1;
  const int kv_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int kv_end = p.causal ? q_hi + 1 : p.S;
  const int t_begin = kv_begin / BK, t_end = (kv_end + BK - 1) / BK;

  const bf16* kbase = p.k + b * p.kb + hk * p.kh;
  const bf16* vbase = p.v + b * p.vb + hk * p.vh;
  load_tile<BQ, DHP>(sQ, p.q + b * p.qb + q_lo * p.qs + h * p.qh, p.qs, p.S - q_lo, p.dh);
  auto load_kv = [&](int t, int buf) {
    const int kv0 = t * BK;
    load_tile<BK, DHP>(sK + buf * BK * LDS, kbase + kv0 * p.ks, p.ks, p.S - kv0, p.dh);
    load_tile<BK, DHP>(sV + buf * BK * LDS, vbase + kv0 * p.vs, p.vs, p.S - kv0, p.dh);
  };
  load_kv(t_begin, 0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = q_lo + warp * 16;  // the warp's first query row
  const int row[2] = {wrow + g, wrow + g + 8};

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = sK + buf * BK * LDS;
    const bf16* v_s = sV + buf * BK * LDS;

    // S = Q K^T for the warp's 16 rows
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_s + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[2 * n2], a, bk[0], bk[1]);
        mma(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, and the online softmax of rows g and g + 8
    const int kv0 = t * BK;
    const bool full = kv0 + BK <= p.S && (!p.causal || kv0 + BK - 1 <= wrow) &&
                      (p.window <= 0 || wrow + 15 - kv0 < p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], c = kv0 + n * 8 + t4 * 2 + (e & 1);
        const bool ok = full || (c < p.S && (!p.causal || c <= r) &&
                                 (p.window <= 0 || r - c < p.window));
        s[n][e] = ok ? s[n][e] * p.scale : kMasked;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = s[n][e] == kMasked ? 0.f : expf(s[n][e] - mx[e >> 1]);
        s[n][e] = pv;
        l[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, P from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                              d2 * 16 + (lane >> 4) * 8);
        mma(o[2 * d2], a, bv[0], bv[1]);
        mma(o[2 * d2 + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  // out = acc / max(l, 1e-30), rounded to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = p.o + b * p.ob + static_cast<int64_t>(row[i]) * p.os + h * p.oh;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + t4 * 2;
      if (c < p.dh) {
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(o[d][2 * i] / denom, o[d][2 * i + 1] / denom);
      }
    }
  }
}

template <int DHP>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = Tile<DHP>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_kernel<DHP><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, Hq, dh), k and v (B, S, Hkv, dh), out (B, S, Hq, dh), all bf16 with unit stride on
// dh and the other strides (elements) as given, multiples of 8, pointers 16-byte aligned.
// window <= 0: none.  Launches on `stream`; returns a CUDA error code (0 on success).
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
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(out),
                 qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh,
                 S, Hq, Hq / Hkv, dh, causal != 0, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch<64>(p, B, s);
  if (dh <= 128) return launch<128>(p, B, s);
  return launch<256>(p, B, s);
}
