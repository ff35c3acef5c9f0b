// K1-pairs: the fused Lemma 4.1 + 4.2 verdict on packed (query path, data path) pairs.
//
//   keep[t] = all_j(qg[t,j] <= eg[t,j] + eps) && all_j(|e0g[t,j] - q0g[t,j]| <= eps)
//
// Replaces the TPU kernel dominance_scan_pairs_kernel / dominance_scan_pairs_pallas
// (src/repro/kernels/dominance_scan/kernel.py:90, :98).  Same contract: row-aligned
// float32 operands qg, eg (T, D) and q0g, e0g (T, D0), all contiguous; the output is
// one byte (0/1) per pair.  No padding to 128 lanes and no power-of-two bucketing of
// T: a block masks its own ragged edge.
//
// Bound: memory.  Each pair reads 4*(2*D + 2*D0) bytes and writes 1 (193 bytes at the
// paper's D = 18, D0 = 6) for 2*(D + D0) compares, so at 3.35 TB/s the card needs
// T * 193 B / 3.35e12 B/s, about 58 us per million pairs; the compares are nothing
// beside that.
//
// Design: one block takes a tile of ROWS consecutive pairs.  The tile's rows of each
// operand are one contiguous span in device memory, so the block copies them into
// shared memory with consecutive threads on consecutive words (fully coalesced),
// then each thread decides one pair from shared memory, D + D0 compares in
// registers.  Every input byte crosses the memory bus once.
//
// Exactness: the sums are __fadd_rn / __fsub_rn in float32 with eps passed as a float32,
// as NumPy and JAX compute them (a float32 array against a weak Python scalar).  Build
// without --use_fast_math: flushing denormals to zero could flip a tie.  NaN compares
// false and +inf rows compare as IEEE says, as in the reference.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void dominance_scan_pairs_kernel(const float* __restrict__ qg,
                                            const float* __restrict__ q0g,
                                            const float* __restrict__ eg,
                                            const float* __restrict__ e0g,
                                            uint8_t* __restrict__ out, int64_t T, int D, int D0,
                                            float eps) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  float* s_q = smem;
  float* s_e = s_q + rows * D;
  float* s_q0 = s_e + rows * D;
  float* s_e0 = s_q0 + rows * D0;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int n = static_cast<int>(T - t0 < rows ? T - t0 : rows);

  const int64_t base = t0 * D;
  for (int i = threadIdx.x; i < n * D; i += rows) {
    s_q[i] = qg[base + i];
    s_e[i] = eg[base + i];
  }
  const int64_t base0 = t0 * D0;
  for (int i = threadIdx.x; i < n * D0; i += rows) {
    s_q0[i] = q0g[base0 + i];
    s_e0[i] = e0g[base0 + i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= n) return;
  bool keep = true;
  for (int j = 0; j < D; ++j) {
    keep &= s_q[r * D + j] <= __fadd_rn(s_e[r * D + j], eps);
  }
  for (int j = 0; j < D0; ++j) {
    keep &= fabsf(__fsub_rn(s_e0[r * D0 + j], s_q0[r * D0 + j])) <= eps;
  }
  out[t0 + r] = keep ? 1 : 0;
}

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dominance_scan_pairs(const void* qg, const void* q0g, const void* eg,
                                    const void* e0g, void* out, int T, int D, int D0, float eps,
                                    void* stream) {
  if (T <= 0) return 0;
  const int row_bytes = 4 * (2 * D + 2 * D0);
  int rows = 256;
  while (rows > 32 && rows * row_bytes > kDefaultSmem) rows /= 2;
  const int smem = rows * row_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        dominance_scan_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (static_cast<int64_t>(T) + rows - 1) / rows;
  dominance_scan_pairs_kernel<<<static_cast<unsigned>(blocks), rows, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qg), static_cast<const float*>(q0g),
      static_cast<const float*>(eg), static_cast<const float*>(e0g),
      static_cast<uint8_t*>(out), T, D, D0, eps);
  return static_cast<int>(cudaGetLastError());
}
