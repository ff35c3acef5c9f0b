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
// Bound: operations.  2 * B * D^2 multiply-adds against 4 * (3 * B * D + D^2 + D) bytes:
// at D = 429 about 71 operations a byte, past the card's 20 for float32 outside the
// tensor cores.  Design: a tiled SIMT GEMM in full float32 (no TF32: the reference is
// float32 on the CPU).  A block of kThreads threads owns a BM x BN output tile; it walks
// D in slices of BK, staging the x slice (transposed, padded against bank conflicts) and
// the w slice in shared memory, and each thread accumulates a TM x TN register tile with
// FMAs, reading its operands as 16-byte shared-memory vectors (two row groups and two
// column groups half a tile apart, so a warp's reads are broadcasts or conflict-free).
// Two shared buffers: while a slice is multiplied, the next one's global loads are in
// flight into registers, then stored to the other buffer.  The epilogue reads b, x0 and
// x at the thread's outputs and writes x0 * (acc + b) + x.  Still simple: no cp.async or
// TMA, no tensor cores.
//
// Sums run over k in order, in float32 FMAs; nvcc contracts the epilogue into one FMA.
// The order differs from a CPU GEMM's, so results agree to a tolerance, not to the bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 128
constexpr int kPad = 4;                           // keeps rows 16-byte aligned
constexpr int kALoads = BM * BK / kThreads;       // x values a thread stages per slice
constexpr int kBLoads = BK * BN / kThreads;       // w values a thread stages per slice

__global__ void __launch_bounds__(kThreads)
    cross_interact_kernel(const float* __restrict__ x0, const float* __restrict__ x,
                          const float* __restrict__ w, const float* __restrict__ b,
                          float* __restrict__ out, int64_t B, int D) {
  __shared__ __align__(16) float As[2][BK][BM + kPad];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group, 0..7
  const int ty = tid / (BN / TN);  // row group, 0..15
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  // The next slice, held in registers while the current one is multiplied.
  float ra[kALoads], rb[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {  // x: consecutive threads on consecutive columns
      const int i = tid + l * kThreads;
      const int64_t gr = row0 + i / BK;
      const int gk = k0 + i % BK;
      ra[l] = (gr < B && gk < D) ? x[gr * D + gk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {  // w: consecutive threads on consecutive columns
      const int i = tid + l * kThreads;
      const int gk = k0 + i / BN, gn = col0 + i % BN;
      rb[l] = (gk < D && gn < D) ? w[static_cast<int64_t>(gk) * D + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int i = tid + l * kThreads;
      As[buf][i % BK][i / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int i = tid + l * kThreads;
      Bs[buf][i / BN][i % BN] = rb[l];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) load(k0 + BK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4 + BM / 2]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4 + BN / 2]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bb[TN] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    // The other buffer was last read before the previous barrier, so it can be
    // refilled now; one barrier per slice.
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (c >= D) continue;
      const int64_t o = r * D + c;
      out[o] = x0[o] * (acc[i][j] + b[c]) + x[o];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cross_interact(const void* x0, const void* x, const void* w, const void* b,
                              void* out, int64_t B, int D, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const int64_t row_tiles = (B + BM - 1) / BM;
  const int col_tiles = (D + BN - 1) / BN;
  if (row_tiles > 0x7fffffff || col_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(col_tiles));
  cross_interact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), B, D);
  return static_cast<int>(cudaGetLastError());
}
