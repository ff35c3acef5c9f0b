// The dominance verdicts of the leaf filter: K1-pairs on packed pairs, and the dense
// scans K3-single (one query against N rows) and K3-batch (Q queries x N rows).
//
//   keep = all_j(q[j] <= e[j] + eps) && all_j(|e0[j] - q0[j]| <= eps)
//
// Replaces the TPU kernels (src/repro/kernels/dominance_scan/kernel.py)
//   K1-pairs   dominance_scan_pairs_kernel / dominance_scan_pairs_pallas  (:90, :98)
//   K3-single  dominance_scan_kernel / dominance_scan_pallas              (:34, :129)
//   K3-batch   dominance_scan_batch_kernel / dominance_scan_batch_pallas  (:44, :58)
// Same contracts: float32 operands, all contiguous; the output is one byte (0/1) per
// pair or cell.  No padding to 128 lanes and no padding or bucketing of T, N or Q: a
// block masks its own ragged edge.  The three kernels decide each element through the
// same two device functions (dominated, label_match), so their verdicts cannot drift.
//
// K1-pairs.  Bound: memory.  Each pair reads 4*(2*D + 2*D0) bytes and writes 1 (193
// bytes at the paper's D = 18, D0 = 6) for 2*(D + D0) compares, so at 3.35 TB/s the
// card needs T * 193 B / 3.35e12 B/s, about 58 us per million pairs; the compares are
// nothing beside that.  Design: one block takes a tile of ROWS consecutive pairs.  The
// tile's rows of each operand are one contiguous span in device memory, so the block
// copies them into shared memory with consecutive threads on consecutive words (fully
// coalesced), then each thread decides one pair from shared memory.
//
// K3-single.  Bound: memory, 4*(D + D0) bytes read and 1 written per row.  Design as
// K1, with the one query row broadcast to the tile from shared memory.
//
// K3-batch.  Bound: bytes or operations, by Q.  Each cell costs 2*D + 3*D0 float32
// operations and one output byte, each row 4*(D + D0) input bytes shared by the Q
// cells of its column: at D = 18, D0 = 6 the operations pass the bytes from Q of about
// 60 up.  Design: a 2-D grid; each block stages kBatchRows data rows and kBatchQueries
// query rows in shared memory (coalesced), then each thread takes one data row and
// walks the block's queries, reading the query rows as shared-memory broadcasts.  The
// (Q, N) output is written row by row, consecutive threads on consecutive bytes.
//
// Exactness: the sums are __fadd_rn / __fsub_rn in float32 with eps passed as a float32,
// as NumPy and JAX compute them (a float32 array against a weak Python scalar).  Build
// without --use_fast_math: flushing denormals to zero could flip a tie.  NaN compares
// false and +inf rows compare as IEEE says, as in the reference.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ bool dominated(float q, float e, float eps) {
  return q <= __fadd_rn(e, eps);
}

__device__ __forceinline__ bool label_match(float q0, float e0, float eps) {
  return fabsf(__fsub_rn(e0, q0)) <= eps;
}

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
    keep &= dominated(s_q[r * D + j], s_e[r * D + j], eps);
  }
  for (int j = 0; j < D0; ++j) {
    keep &= label_match(s_q0[r * D0 + j], s_e0[r * D0 + j], eps);
  }
  out[t0 + r] = keep ? 1 : 0;
}

// One query row (q, q0) against N data rows.
__global__ void dominance_scan_kernel(const float* __restrict__ q, const float* __restrict__ q0,
                                      const float* __restrict__ emb,
                                      const float* __restrict__ emb0, uint8_t* __restrict__ out,
                                      int64_t N, int D, int D0, float eps) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  float* s_e = smem;
  float* s_e0 = s_e + rows * D;
  float* s_q = s_e0 + rows * D0;
  float* s_q0 = s_q + D;

  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int n = static_cast<int>(N - n0 < rows ? N - n0 : rows);
  for (int i = threadIdx.x; i < n * D; i += rows) s_e[i] = emb[n0 * D + i];
  for (int i = threadIdx.x; i < n * D0; i += rows) s_e0[i] = emb0[n0 * D0 + i];
  for (int i = threadIdx.x; i < D; i += rows) s_q[i] = q[i];
  for (int i = threadIdx.x; i < D0; i += rows) s_q0[i] = q0[i];
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= n) return;
  bool keep = true;
  for (int j = 0; j < D; ++j) keep &= dominated(s_q[j], s_e[r * D + j], eps);
  for (int j = 0; j < D0; ++j) keep &= label_match(s_q0[j], s_e0[r * D0 + j], eps);
  out[n0 + r] = keep ? 1 : 0;
}

constexpr int kBatchRows = 128;
constexpr int kBatchQueries = 16;

// Q query rows against N data rows -> (Q, N); block (x, y) covers data rows
// [x*kBatchRows, ...) and queries [y*kBatchQueries, ...).
__global__ void dominance_scan_batch_kernel(const float* __restrict__ q,
                                            const float* __restrict__ q0,
                                            const float* __restrict__ emb,
                                            const float* __restrict__ emb0,
                                            uint8_t* __restrict__ out, int Q, int64_t N, int D,
                                            int D0, float eps) {
  extern __shared__ float smem[];
  float* s_e = smem;
  float* s_e0 = s_e + kBatchRows * D;
  float* s_q = s_e0 + kBatchRows * D0;
  float* s_q0 = s_q + kBatchQueries * D;

  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBatchRows;
  const int n = static_cast<int>(N - n0 < kBatchRows ? N - n0 : kBatchRows);
  const int qb = blockIdx.y * kBatchQueries;
  const int nq = Q - qb < kBatchQueries ? Q - qb : kBatchQueries;
  for (int i = threadIdx.x; i < n * D; i += kBatchRows) s_e[i] = emb[n0 * D + i];
  for (int i = threadIdx.x; i < n * D0; i += kBatchRows) s_e0[i] = emb0[n0 * D0 + i];
  for (int i = threadIdx.x; i < nq * D; i += kBatchRows) {
    s_q[i] = q[static_cast<int64_t>(qb) * D + i];
  }
  for (int i = threadIdx.x; i < nq * D0; i += kBatchRows) {
    s_q0[i] = q0[static_cast<int64_t>(qb) * D0 + i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= n) return;
  for (int k = 0; k < nq; ++k) {
    bool keep = true;
    for (int j = 0; j < D; ++j) keep &= dominated(s_q[k * D + j], s_e[r * D + j], eps);
    for (int j = 0; j < D0; ++j) keep &= label_match(s_q0[k * D0 + j], s_e0[r * D0 + j], eps);
    out[static_cast<int64_t>(qb + k) * N + n0 + r] = keep ? 1 : 0;
  }
}

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that passes 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The most rows (a power of two in [32, 256]) whose tile of `row_bytes` fits 48 KB.
int tile_rows(int row_bytes) {
  int rows = 256;
  while (rows > 32 && rows * row_bytes > kDefaultSmem) rows /= 2;
  return rows;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dominance_scan_pairs(const void* qg, const void* q0g, const void* eg,
                                    const void* e0g, void* out, int T, int D, int D0, float eps,
                                    void* stream) {
  if (T <= 0) return 0;
  const int rows = tile_rows(4 * (2 * D + 2 * D0));
  const int smem = rows * 4 * (2 * D + 2 * D0);
  cudaError_t err = allow_smem(dominance_scan_pairs_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (static_cast<int64_t>(T) + rows - 1) / rows;
  dominance_scan_pairs_kernel<<<static_cast<unsigned>(blocks), rows, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qg), static_cast<const float*>(q0g),
      static_cast<const float*>(eg), static_cast<const float*>(e0g),
      static_cast<uint8_t*>(out), T, D, D0, eps);
  return static_cast<int>(cudaGetLastError());
}

// K3-single: q (D,), q0 (D0,), emb (N, D), emb0 (N, D0) -> out (N,).
extern "C" int dominance_scan(const void* q, const void* q0, const void* emb, const void* emb0,
                              void* out, int64_t N, int D, int D0, float eps, void* stream) {
  if (N <= 0) return 0;
  const int rows = tile_rows(4 * (D + D0));
  const int smem = (rows + 1) * 4 * (D + D0);
  cudaError_t err = allow_smem(dominance_scan_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (N + rows - 1) / rows;
  dominance_scan_kernel<<<static_cast<unsigned>(blocks), rows, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(q0),
      static_cast<const float*>(emb), static_cast<const float*>(emb0),
      static_cast<uint8_t*>(out), N, D, D0, eps);
  return static_cast<int>(cudaGetLastError());
}

// K3-batch: q (Q, D), q0 (Q, D0), emb (N, D), emb0 (N, D0) -> out (Q, N).
extern "C" int dominance_scan_batch(const void* q, const void* q0, const void* emb,
                                    const void* emb0, void* out, int Q, int64_t N, int D, int D0,
                                    float eps, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const int smem = (kBatchRows + kBatchQueries) * 4 * (D + D0);
  cudaError_t err = allow_smem(dominance_scan_batch_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((N + kBatchRows - 1) / kBatchRows),
                  static_cast<unsigned>((Q + kBatchQueries - 1) / kBatchQueries));
  dominance_scan_batch_kernel<<<grid, kBatchRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(q0),
      static_cast<const float*>(emb), static_cast<const float*>(emb0),
      static_cast<uint8_t*>(out), Q, N, D, D0, eps);
  return static_cast<int>(cudaGetLastError());
}
