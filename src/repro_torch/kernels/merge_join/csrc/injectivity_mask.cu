// K2: the injectivity verdict of the device sort-merge join.
//
//   keep[t] = all_j(new[t,j] not in old[t,:]) && all_{j<j'}(new[t,j] != new[t,j'])
//
// Replaces the TPU kernel injectivity_mask_kernel / injectivity_mask_pallas
// (src/repro/kernels/merge_join/kernel.py:32, :47).  Same contract: row-aligned int32
// ids old (T, Co) and new (T, Cn), any values (the join's sentinels included); the
// output is one byte (0/1) per row.  Rows may be strided: the join hands in the old
// and new column slices of one (T, W) table, so each operand takes its own row
// stride and its columns are unit-stride.  No padding of T or of the columns.
//
// Bound: memory.  A row reads 4*(Co + Cn) bytes and writes 1 (33 bytes at Co = 7,
// Cn = 1) for Co*Cn + Cn*(Cn-1)/2 integer compares, so the bytes take some twenty
// times longer than the compares at the card's int32 rate.
//
// Design: one block takes a tile of ROWS consecutive rows.  It copies the tile's old
// and new ids into shared memory, consecutive threads on consecutive words of a row
// (each row's span is contiguous, so the loads coalesce), then one thread per row
// holds its new ids in registers (at most kMaxNew, a compile-time bound, so the array
// stays in registers) and streams its old ids from shared memory.  Every input byte
// crosses the memory bus once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxNew = 8;
constexpr int kMaxCols = 64;
constexpr int kRows = 256;

__global__ void injectivity_mask_kernel(const int32_t* __restrict__ old_ids, int64_t old_stride,
                                        const int32_t* __restrict__ new_ids, int64_t new_stride,
                                        uint8_t* __restrict__ out, int64_t T, int Co, int Cn) {
  extern __shared__ int32_t smem[];
  int32_t* s_old = smem;
  int32_t* s_new = s_old + kRows * Co;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int n = static_cast<int>(T - t0 < kRows ? T - t0 : kRows);

  for (int i = threadIdx.x; i < n * Co; i += blockDim.x) {
    const int r = i / Co;
    s_old[i] = old_ids[(t0 + r) * old_stride + (i - r * Co)];
  }
  for (int i = threadIdx.x; i < n * Cn; i += blockDim.x) {
    const int r = i / Cn;
    s_new[i] = new_ids[(t0 + r) * new_stride + (i - r * Cn)];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= n) return;
  int32_t nv[kMaxNew];
#pragma unroll
  for (int j = 0; j < kMaxNew; ++j) nv[j] = j < Cn ? s_new[r * Cn + j] : 0;
  bool keep = true;
  for (int k = 0; k < Co; ++k) {
    const int32_t o = s_old[r * Co + k];
#pragma unroll
    for (int j = 0; j < kMaxNew; ++j) keep &= !(j < Cn && nv[j] == o);
  }
#pragma unroll
  for (int j = 0; j < kMaxNew; ++j) {
#pragma unroll
    for (int j2 = j + 1; j2 < kMaxNew; ++j2) keep &= !(j2 < Cn && nv[j] == nv[j2]);
  }
  out[t0 + r] = keep ? 1 : 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths past the kernel's bounds.
extern "C" int injectivity_mask(const void* old_ids, int64_t old_stride, const void* new_ids,
                                int64_t new_stride, void* out, int64_t T, int Co, int Cn,
                                void* stream) {
  if (T <= 0) return 0;
  if (Co < 0 || Cn < 1 || Cn > kMaxNew || Co + Cn > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kRows * (Co + Cn) * 4;  // at most 64 KB
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        injectivity_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (T + kRows - 1) / kRows;
  injectivity_mask_kernel<<<static_cast<unsigned>(blocks), kRows, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(old_ids), old_stride, static_cast<const int32_t*>(new_ids),
      new_stride, static_cast<uint8_t*>(out), T, Co, Cn);
  return static_cast<int>(cudaGetLastError());
}
