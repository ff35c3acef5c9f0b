// K4, the masked gather-sum (an EmbeddingBag in sum mode):
//
//   out[n, :] = sum over k with mask[n, k] of table[idx[n, k], :]
//
// Replaces the TPU kernel src/repro/kernels/star_agg/kernel.py, star_agg_kernel /
// star_agg_pallas (:25, :39).  Same contract: idx (N, K) int32, mask (N, K) bool (one byte
// each), table (V, E) float32, all contiguous -> out (N, E) float32.  The TPU kernel turns
// the gather into a one-hot matmul because the MXU is its only fast unit; the card gathers
// rows directly, so nothing here is a matmul and nothing is padded to a block of rows.
//
// Bound: memory.  A row reads its K ids and mask bytes, E floats for each unmasked slot
// and writes E floats: at the DCN-v2 serve_bulk cell (K = 1, E = 16) 133 bytes for 16
// adds, so the card needs the bytes over 3.35 TB/s and the adds are nothing beside them.
// Design: one thread per (row, 16-byte chunk of the row) where E is a multiple of 4, else
// one thread per (row, float).  Consecutive threads cover consecutive chunks of a row and
// then the next row, so each table row is read as whole 16-byte vectors and the output is
// written fully coalesced.  The threads of a row read the same ids and mask bytes, which
// the warp serves as one broadcast.
//
// Exactness: a masked slot is never loaded, so its id may be anything (-1, >= V).  The
// unmasked slots are summed in slot order, starting from the first of them rather than
// from 0, so K = 1 copies the row bit for bit.  An unmasked id outside [0, V) reads
// nothing and gives NaN, as jnp.take's fill mode does, instead of a fault.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// The value v in every lane of T.
template <typename T>
__device__ __forceinline__ T splat(float v);
template <>
__device__ __forceinline__ float splat<float>(float v) { return v; }
template <>
__device__ __forceinline__ float4 splat<float4>(float v) { return make_float4(v, v, v, v); }

// T is float4 (E % 4 == 0) or float; a row holds `chunks` values of T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    star_agg_kernel(const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
                    const T* __restrict__ table, T* __restrict__ out, int64_t N, int K, int64_t V,
                    int chunks) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * chunks) return;
  const int64_t n = t / chunks;
  const int c = static_cast<int>(t - n * chunks);
  const int32_t* row_idx = idx + n * K;
  const uint8_t* row_mask = mask + n * K;
  T acc = splat<T>(0.f);
  bool any = false;
  for (int k = 0; k < K; ++k) {
    if (!row_mask[k]) continue;
    const int64_t id = row_idx[k];
    const T v = (id >= 0 && id < V) ? table[id * chunks + c] : splat<T>(nanf(""));
    acc = any ? add(acc, v) : v;
    any = true;
  }
  out[n * chunks + c] = acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  `table` and `out`
// must be 16-byte aligned when E % 4 == 0 (every torch allocation is).
extern "C" int star_agg(const void* idx, const void* mask, const void* table, void* out,
                        int64_t N, int K, int64_t V, int E, void* stream) {
  if (N <= 0 || E <= 0) return 0;
  if (K < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int chunks = vec ? E / 4 : E;
  const int64_t blocks = (N * chunks + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    star_agg_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<const float4*>(table), static_cast<float4*>(out), N, K, V, chunks);
  } else {
    star_agg_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(table), static_cast<float*>(out), N, K, V, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
