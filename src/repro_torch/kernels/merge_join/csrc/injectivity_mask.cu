// K2: the injectivity verdict of the device sort-merge join.
//
//   keep[t] = all_j(new[t,j] not in old[t,:]) && all_{j<j'}(new[t,j] != new[t,j'])
//
// Replaces the TPU kernel injectivity_mask_kernel / injectivity_mask_pallas
// (src/repro/kernels/merge_join/kernel.py:32, :47).  Same contract: row-aligned int32
// ids old (T, Co) and new (T, Cn), any values (the join's sentinels included); the
// output is one byte (0/1) per row.  Rows may be strided and columns are unit-stride.
// No padding of T or of the columns.
//
// Bound: memory.  A row reads 4*(Co + Cn) bytes and writes 1 (29 bytes at Co + Cn = 7)
// for Co*Cn + Cn*(Cn-1)/2 integer compares, so the bytes take several times longer than
// the compares at the card's int32 rate.  Everything below serves one aim: keep enough
// bytes in flight that the memory never waits, and spend few instructions per row.
//
// Design:
//   * Layouts.  The join hands in the old and new column slices of one contiguous
//     (T, W = Co + Cn) table, so a tile of rows is one contiguous run of bytes; the
//     wrapper says so (`contiguous`).  Where that table starts on 16 bytes the tile is
//     staged in 16-byte cp.async granules; off 16 bytes, in 4-byte words of the same
//     run.  Any other layout (separate tensors, a wider parent table) is staged in
//     4-byte words from each operand's own rows.  All three fill the same slots.
//   * Slots.  A thread decides 4 consecutive rows.  Their 4*W words are one slot of W
//     granules, padded to an odd number of granules so that a quarter-warp's 16-byte
//     reads of shared memory fall on 8 distinct bank groups.  A tile is one slot a
//     thread: 4 * kThreads rows.
//   * Ring and persistent grid.  At most kBlocksPerSm blocks an SM walk the tiles, each
//     with a ring of kStages tiles in flight: a tile moves into registers, its stage
//     takes the copy of the tile kStages on, and the tile is decided while the next
//     ones arrive.  A launch asks for only the stages its blocks can use, so a small
//     step pays for one.  At W = 7 a stage is 14 KB, so two blocks keep some 57 KB of
//     reads in flight an SM.
//   * Widths.  Each W from 1 to 16 (the join's: a query has at most a few dozen vertices
//     and the paper's default is 8) is its own instantiation: a thread's 4 rows sit in
//     registers, read by W 16-byte loads, and a new column is compared with every
//     earlier column behind warp-uniform branches on Co, Co*Cn + Cn*(Cn-1)/2 compares a
//     row.  Wider rows (17 to 64) take one runtime-width instantiation that keeps a
//     row's new ids in registers and streams its old ids from shared memory (4-way bank
//     conflicts there).  No index math divides at run time: a compile-time width
//     divides by a constant, the runtime width by a multiply-high with ceil(2^32 / W).
//   * Stores.  A thread stores its 4 verdicts as one 4-byte word where the word is
//     aligned and whole, bytes at the ragged end.
//   * Host.  The SM count, the shared-memory opt-in and the blocks that fit an SM are
//     asked once per device or instantiation and kept; a launch makes no other query.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxNew = 8;
constexpr int kMaxCols = 64;
constexpr int kMaxFixed = 16;     // widths held in registers, one instantiation each
constexpr int kThreads = 128;     // fixed widths: 512-row tiles
constexpr int kStages = 3;
constexpr int kWideThreads = 64;  // the runtime width: 256-row tiles
constexpr int kWideStages = 2;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

// How a tile reaches shared memory.
enum Layout : int { kGranules = 0, kWords = 1, kStrided = 2 };

__host__ __device__ constexpr int slot_granules(int w) { return w % 2 ? w : w + 1; }

// The row width: kW at compile time, or (kW = 0) at run time, dividing by a
// multiply-high with magic = ceil(2^32 / w), exact for x < 2^32 / w (x < 2^14 here).
template <int kW>
struct Width {
  __device__ __forceinline__ int w() const { return kW; }
  __device__ __forceinline__ unsigned div(unsigned x) const { return x / kW; }
};

template <>
struct Width<0> {
  int w_;
  unsigned magic;
  __device__ __forceinline__ int w() const { return w_; }
  __device__ __forceinline__ unsigned div(unsigned x) const { return __umulhi(x, magic); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's latest copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts (does not wait for) the copy of tile `tile`'s rows into `slots`: row r of the
// tile goes to slot r / 4, at word (r % 4) * W.  Rows past T are not copied.
template <int kW, int kT>
__device__ __forceinline__ void stage_tile(int4* slots, int sg, const int32_t* old_ids,
                                           int64_t so, const int32_t* new_ids, int64_t sn,
                                           int64_t T, int Co, Width<kW> width, int layout,
                                           int64_t tile) {
  const int W = width.w();
  const int64_t t0 = tile * (4 * kT);
  const int rows = T - t0 < 4 * kT ? static_cast<int>(T - t0) : 4 * kT;
  if (layout == kGranules) {
    // the tile is rows * W words of one run that starts on 16 bytes (t0 * W * 4 is a
    // multiple of 16); granule g is word 4g of it, so slot g / W, granule g % W
    const char* src = reinterpret_cast<const char*>(old_ids + t0 * W);
    const int bytes = rows * W * 4;
    for (int g = threadIdx.x; g * 16 < bytes; g += kT) {
      const int s = static_cast<int>(width.div(g)), o = g - s * W;
      const int left = bytes - g * 16;
      cp_async16(slots + s * sg + o, src + 16 * g, left < 16 ? left : 16);
    }
  } else {
    int32_t* words = reinterpret_cast<int32_t*>(slots);
    for (int e = threadIdx.x; e < rows * W; e += kT) {
      const int r = static_cast<int>(width.div(e)), k = e - r * W;
      const int32_t* src =
          layout == kWords ? old_ids + t0 * W + e
          : k < Co         ? old_ids + (t0 + r) * so + k
                           : new_ids + (t0 + r) * sn + (k - Co);
      cp_async4(words + (r >> 2) * (4 * sg) + (r & 3) * W + k, src);
    }
  }
}

__device__ __forceinline__ uint32_t pack(const bool (&keep)[4]) {
  return static_cast<uint32_t>(keep[0]) | static_cast<uint32_t>(keep[1]) << 8 |
         static_cast<uint32_t>(keep[2]) << 16 | static_cast<uint32_t>(keep[3]) << 24;
}

// A thread's 4 rows of kW words from its slot into registers.
template <int kW>
__device__ __forceinline__ void load_rows(int32_t (&v)[4 * kW], const int4* slot) {
#pragma unroll
  for (int g = 0; g < kW; ++g) {
    const int4 x = slot[g];
    v[4 * g] = x.x;
    v[4 * g + 1] = x.y;
    v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

// Column kp of a row (a new one where kp >= Co) against every earlier column: that
// covers each (new, old) and each (new, new) pair once.
template <int kW>
__device__ __forceinline__ uint32_t decide_fixed(const int32_t (&v)[4 * kW], int Co) {
  bool keep[4] = {true, true, true, true};
#pragma unroll
  for (int kp = 1; kp < kW; ++kp) {
    if (kp < Co) continue;  // an old column: old ids may repeat
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < kp; ++k) keep[i] &= v[i * kW + k] != v[i * kW + kp];
    }
  }
  return pack(keep);
}

// The runtime width: a row's new ids in registers, its old ids streamed from `slot`.
__device__ __forceinline__ uint32_t decide_wide(const int32_t* slot, int W, int Co) {
  const int Cn = W - Co;
  bool keep[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t* row = slot + i * W;
    int32_t nv[kMaxNew];
#pragma unroll
    for (int j = 0; j < kMaxNew; ++j) nv[j] = j < Cn ? row[Co + j] : 0;
    bool ok = true;
#pragma unroll
    for (int j = 1; j < kMaxNew; ++j) {
#pragma unroll
      for (int j0 = 0; j0 < j; ++j0) ok &= !(j < Cn && nv[j0] == nv[j]);
    }
    for (int k = 0; k < Co; ++k) {
      const int32_t o = row[k];
#pragma unroll
      for (int j = 0; j < kMaxNew; ++j) ok &= !(j < Cn && nv[j] == o);
    }
    keep[i] = ok;
  }
  return pack(keep);
}

// A thread's 4 verdict bytes at p: one 4-byte store where the word is aligned and
// whole, bytes otherwise.
__device__ __forceinline__ void put(uint8_t* p, uint32_t word, int nvalid) {
  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = word;
  } else {
    for (int i = 0; i < nvalid; ++i) p[i] = static_cast<uint8_t>((word >> (8 * i)) & 1u);
  }
}

template <int kW, int kT, int kS>
__global__ void __launch_bounds__(kT, kBlocksPerSm)
    injectivity_mask_kernel(const int32_t* __restrict__ old_ids, int64_t so,
                            const int32_t* __restrict__ new_ids, int64_t sn,
                            uint8_t* __restrict__ out, int64_t T, int Co, Width<kW> width,
                            int layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* const ring = reinterpret_cast<int4*>(smem);
  const int sg = slot_granules(width.w());
  const int stage_granules = kT * sg;
  const int64_t n_tiles = (T + 4 * kT - 1) / (4 * kT);

  // The block's j-th tile into stage j % kS; every call commits one copy group, empty
  // or not, so that the groups count the tiles.
  auto stage = [&](int j) {
    const int64_t tile = blockIdx.x + static_cast<int64_t>(j) * gridDim.x;
    if (tile < n_tiles) {
      stage_tile<kW, kT>(ring + (j % kS) * stage_granules, sg, old_ids, so, new_ids, sn, T,
                         Co, width, layout, tile);
    }
    cp_async_commit();
  };

  for (int j = 0; j < kS; ++j) stage(j);
  for (int j = 0;; ++j) {
    const int64_t tile = blockIdx.x + static_cast<int64_t>(j) * gridDim.x;
    if (tile >= n_tiles) break;
    cp_async_wait<kS - 1>();
    __syncthreads();  // tile j has landed for every thread's copies
    const int4* slot = ring + (j % kS) * stage_granules + threadIdx.x * sg;
    uint32_t word;
    if constexpr (kW > 0) {
      int32_t v[4 * kW];
      load_rows<kW>(v, slot);
      __syncthreads();  // every thread has its rows: the stage takes tile j + kS
      stage(j + kS);
      word = decide_fixed<kW>(v, Co);
    } else {
      word = decide_wide(reinterpret_cast<const int32_t*>(slot), width.w(), Co);
      __syncthreads();
      stage(j + kS);
    }
    const int64_t r0 = tile * (4 * kT) + 4 * threadIdx.x;
    if (r0 < T) put(out + r0, word, T - r0 < 4 ? static_cast<int>(T - r0) : 4);
  }
}

// ---- host -------------------------------------------------------------------

std::atomic<int> g_sms[kMaxDevices];  // SM count by device (0: not asked yet)

// The dynamic shared memory of a full ring at width W.
template <int kT, int kS>
constexpr int ring_bytes(int W) {
  return kS * kT * slot_granules(W) * 16;
}

template <int kW, int kT, int kS>
int launch(const int32_t* old_ids, int64_t so, const int32_t* new_ids, int64_t sn, uint8_t* out,
           int64_t T, int Co, int W, int layout, int device, cudaStream_t stream) {
  auto kernel = injectivity_mask_kernel<kW, kT, kS>;
  // once per instantiation and device: opt in to the widest ring it serves
  static std::atomic<int> opted[kMaxDevices];
  if (opted[device].load(std::memory_order_relaxed) == 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_bytes<kT, kS>(kW > 0 ? kW : kMaxCols));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device].store(1, std::memory_order_relaxed);
  }
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device].store(sms, std::memory_order_relaxed);
  }
  // once per width: the blocks an SM holds at a full ring, at most kBlocksPerSm
  static std::atomic<int> fit[kMaxCols + 1];
  int per_sm = fit[W].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kT, ring_bytes<kT, kS>(W));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm = per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm;
    fit[W].store(per_sm, std::memory_order_relaxed);
  }
  const int64_t n_tiles = (T + 4 * kT - 1) / (4 * kT);
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  const int64_t grid = n_tiles < most ? n_tiles : most;
  const int64_t per_block = (n_tiles + grid - 1) / grid;  // stages a block can use
  const int smem = static_cast<int>(per_block < kS ? per_block : kS) * ring_bytes<kT, 1>(W);
  Width<kW> width;
  if constexpr (kW == 0) width = {W, 0xffffffffu / static_cast<unsigned>(W) + 1u};
  kernel<<<static_cast<unsigned>(grid), kT, smem, stream>>>(old_ids, so, new_ids, sn, out, T, Co,
                                                           width, layout);
  return static_cast<int>(cudaGetLastError());
}

template <int kW>
int launch_fixed(const int32_t* old_ids, int64_t so, const int32_t* new_ids, int64_t sn,
                 uint8_t* out, int64_t T, int Co, int W, int layout, int device,
                 cudaStream_t stream) {
  if constexpr (kW > kMaxFixed) {
    return launch<0, kWideThreads, kWideStages>(old_ids, so, new_ids, sn, out, T, Co, W, layout,
                                                device, stream);
  } else {
    if (W == kW) {
      return launch<kW, kThreads, kStages>(old_ids, so, new_ids, sn, out, T, Co, W, layout,
                                           device, stream);
    }
    return launch_fixed<kW + 1>(old_ids, so, new_ids, sn, out, T, Co, W, layout, device, stream);
  }
}

}  // namespace

// old (T, Co) with row stride `old_stride`, new (T, Cn) with `new_stride` (in ids),
// columns unit-stride -> out (T,) bytes.  `contiguous`: the caller vouches that the
// operands are one contiguous (T, Co + Cn) table (new starts Co ids past old and both
// row strides are Co + Cn); the kernel then reads that table from new - Co.  `device`
// is the CUDA device of the operands.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths past the kernel's bounds.
extern "C" int injectivity_mask(const void* old_ids, int64_t old_stride, const void* new_ids,
                                int64_t new_stride, void* out, int64_t T, int Co, int Cn,
                                int contiguous, int device, void* stream) {
  if (T <= 0) return 0;
  if (Co < 0 || Cn < 1 || Cn > kMaxNew || Co + Cn > kMaxCols || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the table starts Co ids before new (old may be an empty view at Co = 0)
  const int32_t* table = static_cast<const int32_t*>(new_ids) - Co;
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int layout = !contiguous ? kStrided : aligned ? kGranules : kWords;
  return launch_fixed<1>(contiguous ? table : static_cast<const int32_t*>(old_ids), old_stride,
                         static_cast<const int32_t*>(new_ids), new_stride,
                         static_cast<uint8_t*>(out), T, Co, Co + Cn, layout, device,
                         static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory, in bytes, of a full ring at row width W (0 past the
// kernel's bounds): for reports.
extern "C" int injectivity_mask_ring_bytes(int W) {
  if (W < 1 || W > kMaxCols) return 0;
  return W <= kMaxFixed ? ring_bytes<kThreads, kStages>(W)
                        : ring_bytes<kWideThreads, kWideStages>(W);
}
