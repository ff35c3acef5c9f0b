// The dominance verdicts of the leaf filter: K1-pairs on packed pairs, and the dense
// scans K3-single (one query against N rows) and K3-batch (Q queries x N rows).
//
//   keep = all_j(q[j] <= e[j] + eps) && all_j(|e0[j] - q0[j]| <= eps)
//
// Replaces the TPU kernels (src/repro/kernels/dominance_scan/kernel.py)
//   K1-pairs   dominance_scan_pairs_kernel / dominance_scan_pairs_pallas  (:90, :98)
//   K3-single  dominance_scan_kernel / dominance_scan_pallas              (:34, :129)
//   K3-batch   dominance_scan_batch_kernel / dominance_scan_batch_pallas  (:44, :58)
// Same contracts: float32 operands, all contiguous, at any 4-byte offset; the output is
// one byte (0/1) per pair or cell.  No padding to 128 lanes and no padding or bucketing
// of T, N or Q: a block masks its own ragged edge.  The kernels decide each element
// through the same two comparisons (dominated, label_match; the dense scans take the
// add of dominated once per data element, with the same bits), so their verdicts cannot
// drift.
//
// K1-pairs.  Bound: memory.  Each pair reads 4*(2*D + 2*D0) bytes and writes 1 (193
// bytes at the paper's D = 18, D0 = 6) for 2*(D + D0) compares, so at 3.35 TB/s the
// card needs T * 193 B / 3.35e12 B/s, about 58 us per million pairs; the compares are
// nothing beside that.  Design: one block takes a tile of ROWS consecutive pairs.  The
// tile's rows of each operand are one contiguous span in device memory, so the block
// copies them into shared memory with consecutive threads on consecutive words (fully
// coalesced), then each thread decides one pair from shared memory.
//
// K3 (both forms; K3-single is the same kernel at Q = 1).  Bound: memory.  Every data
// row is 4*(D + D0) input bytes, every cell one output byte; a cell costs D compares and
// D0 subtract-compares, the e + eps add is once per data element.  At the paper's widths
// and Q = 70 the bytes (73.6 MB read, 53.7 MB written at N = 766,664) outweigh the
// compares, provided no cell pays for more than that.  Design:
//   * Persistent blocks of 12 warps, one per SM.  Each warp walks tiles of 128 data
//     rows, 4 consecutive rows a lane, and reads every data row from device memory once
//     for all Q queries.  The block keeps the queries in shared memory (q then q0, each
//     padded to 16 bytes, read as broadcasts); only when they do not fit does it walk
//     query tiles inside the data tile, the data staying in registers.
//   * A warp stages its next tile with cp.async (16-byte granules when the array starts
//     on 16 bytes and the tile is whole rows, 4-byte words otherwise) into 32 lane slots
//     whose odd stride in 16-byte granules makes the lanes' 16-byte reads conflict free.
//     The copy starts as soon as this tile has moved into registers, so it is in
//     flight while this tile is decided.  One tile in flight a warp (kStages = 1) and 12
//     warps beat deeper rings with fewer warps (8 x 2, 4 x 4): at 70 queries the
//     deciding needs the warps to hide its latency, and one query alone is held by the
//     memory either way (tools/k3_variants.py).
//   * A lane holds its 4 rows in registers with e + eps already added (__fadd_rn: the
//     same bits as the per-cell form), so a cell is D compares and D0 subtract-compares.
//   * Labels first, with warp votes: after the first label column and after all of
//     them, a query that no lane's row still matches skips the rest.  The verdict is an
//     AND of comparisons, so the order changes no bit, NaN included.  On the 50K cell's
//     index, sorted by labels, the votes halve the scan of 70 queries; where every
//     label matches they cost 9 % (tools/k3_variants.py).  Rows past N carry NaN
//     labels, which match nothing, so no per-cell check masks them.
//   * A lane stores its 4 verdicts of a query as one 4-byte word, so a warp writes 128
//     consecutive bytes; at an unaligned word (N % 4 != 0) or a ragged end, bytes.
//   * Widths are compile-time so that the rows live in registers: the paper's D = 18,
//     D0 = 6 exactly; any other width through chunks of 16 and 8 columns, where padded
//     columns are neutral (e + eps = +inf against q = -inf, labels 0 against 0) and each
//     later chunk ANDs its verdicts into the output words the first one wrote.
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

// ---- K3 ---------------------------------------------------------------------

constexpr int kWarps = 12;
constexpr int kStages = 1;  // a warp's ring of tiles in flight
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 128;  // a warp's tile: 4 consecutive rows a lane
constexpr unsigned kAll = 0xffffffffu;

// A lane slot holds 4 rows of w floats, w 16-byte granules; an odd stride in granules
// puts the 8 lanes of each quarter-warp's 16-byte reads on 8 distinct bank groups.
constexpr int slot_granules(int w) { return w % 2 ? w : w + 1; }
constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The layout of an instantiation that holds CD dominance and CD0 label columns of a row
// in registers.
template <int CD, int CD0>
struct Scan {
  static constexpr int kSlot = slot_granules(CD);
  static constexpr int kSlot0 = slot_granules(CD0);
  static constexpr int kStageBytes = 32 * 16 * (kSlot + kSlot0);
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kQ = round4(CD);    // a query chunk: q, padded to 16 bytes,
  static constexpr int kQ0 = round4(CD0);  // then q0
  static constexpr int kQChunk = kQ + kQ0;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ int width(int left, int cap) {
  return left <= 0 ? 0 : (left < cap ? left : cap);
}

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

// Starts (does not wait for) the copy of rows [r0, r0 + 128) of columns [c0, c0 + w) of
// the row-major (N, D) array `base` into the warp's lane slots: slot s takes rows
// r0 + 4s .. r0 + 4s + 3, row i at float i * CW.  Rows past N are not copied.
template <int CW, int kSlot>
__device__ __forceinline__ void stage_rows(float4* slots, const float* base, int64_t N, int D,
                                           int c0, int w, int64_t r0, int lane) {
  const int64_t left = N - r0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;
  if (rows <= 0 || w <= 0) return;
  if (D == CW && (reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    // whole rows (so c0 = 0, w = D) on a 16-byte base: a lane slot is 4 * D floats =
    // D granules of one contiguous span, and r0 * D * 4 is a multiple of 512
    const char* src = reinterpret_cast<const char*>(base + r0 * D);
    const int bytes = rows * CW * 4;
    for (int g = lane; g * 16 < bytes; g += 32) {
      const int s = g / CW, o = g - s * CW;
      const int n = bytes - g * 16;
      cp_async16(slots + s * kSlot + o, src + 16 * g, n < 16 ? n : 16);
    }
  } else {
    for (int e = lane; e < rows * w; e += 32) {
      const int r = e / w, j = e - r * w;
      float* dst = reinterpret_cast<float*>(slots + (r >> 2) * kSlot) + (r & 3) * CW + j;
      cp_async4(dst, base + (r0 + r) * D + c0 + j);
    }
  }
}

// A lane's 4 rows of CW floats from its slot into registers.
template <int CW, int kSlot>
__device__ __forceinline__ void load_rows(float (&v)[4 * CW], const float4* slots, int lane) {
  const float4* my = slots + lane * kSlot;
#pragma unroll
  for (int g = 0; g < CW; ++g) {
    const float4 x = my[g];
    v[4 * g] = x.x;
    v[4 * g + 1] = x.y;
    v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

// Queries [k0, k0 + nq) into shared memory, each as nc chunks of (q, q0) with neutral
// padding: q -inf past D (against e + eps = +inf), q0 0 past D0 (against 0).
template <int CD, int CD0>
__device__ void load_queries(float* s_q, const float* q, const float* q0, int k0, int nq, int D,
                             int D0, int nc) {
  using S = Scan<CD, CD0>;
  const int row = nc * S::kQChunk;
  for (int i = threadIdx.x; i < nq * row; i += kThreads) {
    const int k = i / row, f = i - k * row, c = f / S::kQChunk, g = f - c * S::kQChunk;
    const int64_t qk = static_cast<int64_t>(k0) + k;
    float v;
    if (g < S::kQ) {
      const int j = c * CD + g;
      v = g < CD && j < D ? q[qk * D + j] : -inf();
    } else {
      const int j = c * CD0 + g - S::kQ;
      v = g - S::kQ < CD0 && j < D0 ? q0[qk * D0 + j] : 0.f;
    }
    s_q[i] = v;
  }
}

// One query chunk against a lane's 4 rows → their verdicts, one byte each.  `ev` holds
// e + eps, `e0v` the labels (NaN on rows past N, so that they never hold a vote open;
// their bytes are never stored).  Warp-uniform control flow: every lane of the warp
// calls it for the same query.
template <int CD, int CD0>
__device__ __forceinline__ uint32_t decide(const float* qk, const float (&ev)[4 * CD],
                                           const float (&e0v)[4 * CD0], int w0, float eps) {
  using S = Scan<CD, CD0>;
  bool keep[4] = {true, true, true, true};
  if (w0 > 0) {
    float a[S::kQ0];
    const float4* qa = reinterpret_cast<const float4*>(qk + S::kQ);
#pragma unroll
    for (int g = 0; g < S::kQ0 / 4; ++g) {
      const float4 x = qa[g];
      a[4 * g] = x.x;
      a[4 * g + 1] = x.y;
      a[4 * g + 2] = x.z;
      a[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] &= label_match(a[0], e0v[i * CD0], eps);
    if (!__any_sync(kAll, keep[0] | keep[1] | keep[2] | keep[3])) return 0;
#pragma unroll
    for (int j = 1; j < CD0; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) keep[i] &= label_match(a[j], e0v[i * CD0 + j], eps);
    }
    if (!__any_sync(kAll, keep[0] | keep[1] | keep[2] | keep[3])) return 0;
  }
  float b[S::kQ];
  const float4* qb = reinterpret_cast<const float4*>(qk);
#pragma unroll
  for (int g = 0; g < S::kQ / 4; ++g) {
    const float4 x = qb[g];
    b[4 * g] = x.x;
    b[4 * g + 1] = x.y;
    b[4 * g + 2] = x.z;
    b[4 * g + 3] = x.w;
  }
#pragma unroll
  for (int j = 0; j < CD; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) keep[i] &= b[j] <= ev[i * CD + j];
  }
  return static_cast<uint32_t>(keep[0]) | static_cast<uint32_t>(keep[1]) << 8 |
         static_cast<uint32_t>(keep[2]) << 16 | static_cast<uint32_t>(keep[3]) << 24;
}

// Writes a lane's 4 verdict bytes at p (kAnd: ANDs them into what is there): one 4-byte
// store where the word is aligned and whole, bytes otherwise.  Two instantiations, so
// that the plain store never waits on a read of the output.
template <bool kAnd>
__device__ __forceinline__ void put(uint8_t* p, uint32_t word, int nvalid) {
  if (nvalid == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    uint32_t* p4 = reinterpret_cast<uint32_t*>(p);
    *p4 = kAnd ? word & *p4 : word;
  } else {
    for (int i = 0; i < nvalid; ++i) {
      const uint8_t b = static_cast<uint8_t>((word >> (8 * i)) & 1u);
      p[i] = kAnd ? static_cast<uint8_t>(b & p[i]) : b;
    }
  }
}

// Q query rows against N data rows → (Q, N); nc column chunks, QT queries a query tile.
template <int CD, int CD0>
__global__ void __launch_bounds__(kThreads, 1)
    dominance_scan_batch_kernel(const float* __restrict__ q, const float* __restrict__ q0,
                                const float* __restrict__ emb, const float* __restrict__ emb0,
                                uint8_t* __restrict__ out, int Q, int64_t N, int D, int D0,
                                int nc, int QT, float eps) {
  using S = Scan<CD, CD0>;
  extern __shared__ __align__(16) unsigned char slots[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* const ring = slots + warp * S::kWarpBytes;
  float* const s_q = reinterpret_cast<float*>(slots + kWarps * S::kWarpBytes);
  const int qrow = nc * S::kQChunk;
  const int64_t n_bt = (N + kWarps * kTileRows - 1) / (kWarps * kTileRows);
  const int n_qt = (Q + QT - 1) / QT;

  // The warp's copies, in the order it decides them: job j is block tile bt, chunk c (one
  // chunk: once per block tile, its rows staying in registers across query tiles; more:
  // every chunk again for every query tile).  Job j goes to stage j % kStages, and every
  // job commits one copy group, empty or not, so that the groups count the jobs.
  auto stage_job = [&](int64_t j) {
    int64_t bt = j;
    int c = 0;
    if (nc > 1) {
      c = static_cast<int>(j % nc);
      bt = j / nc / n_qt;
    }
    bt = blockIdx.x + bt * gridDim.x;
    if (bt < n_bt) {
      float4* const s_e = reinterpret_cast<float4*>(ring + (j % kStages) * S::kStageBytes);
      const int64_t r0 = (bt * kWarps + warp) * kTileRows;
      stage_rows<CD, S::kSlot>(s_e, emb, N, D, c * CD, width(D - c * CD, CD), r0, lane);
      stage_rows<CD0, S::kSlot0>(s_e + 32 * S::kSlot, emb0, N, D0, c * CD0,
                                 width(D0 - c * CD0, CD0), r0, lane);
    }
    cp_async_commit();
  };

  for (int j = 0; j < kStages; ++j) stage_job(j);
  if (n_qt == 1) {
    load_queries<CD, CD0>(s_q, q, q0, 0, Q, D, D0, nc);
    __syncthreads();
  }
  float ev[4 * CD], e0v[4 * CD0];
  int64_t job = 0;
  for (int64_t bt = blockIdx.x; bt < n_bt; bt += gridDim.x) {
    const int64_t tile = (bt * kWarps + warp) * kTileRows;  // past N: staged and synced only
    const int64_t r0 = tile + 4 * lane;                       // this lane's rows
    const int nvalid = static_cast<int>(N - r0 <= 0 ? 0 : (N - r0 < 4 ? N - r0 : 4));
    for (int qt = 0; qt < n_qt; ++qt) {
      const int k0 = qt * QT, k1 = Q - k0 < QT ? Q : k0 + QT;
      if (n_qt > 1) {
        __syncthreads();
        load_queries<CD, CD0>(s_q, q, q0, k0, k1 - k0, D, D0, nc);
        __syncthreads();
      }
      for (int c = 0; c < nc; ++c) {
        const int w = width(D - c * CD, CD), w0 = width(D0 - c * CD0, CD0);
        if (nc > 1 || qt == 0) {
          cp_async_wait<kStages - 1>();
          __syncwarp();
          const float4* s_e =
              reinterpret_cast<const float4*>(ring + (job % kStages) * S::kStageBytes);
          load_rows<CD, S::kSlot>(ev, s_e, lane);
          load_rows<CD0, S::kSlot0>(e0v, s_e + 32 * S::kSlot, lane);
          __syncwarp();  // every lane has its rows: the stage takes the copy kStages jobs on
          stage_job(job + kStages);
          ++job;
#pragma unroll
          for (int f = 0; f < 4 * CD; ++f) ev[f] = f % CD < w ? __fadd_rn(ev[f], eps) : inf();
#pragma unroll
          for (int f = 0; f < 4 * CD0; ++f) {
            e0v[f] = f / CD0 >= nvalid ? __int_as_float(0x7fffffff) : f % CD0 < w0 ? e0v[f] : 0.f;
          }
        }
        const float* qc = s_q + c * S::kQChunk;
        uint8_t* o = out + static_cast<int64_t>(k0) * N + r0;
        if (tile < N && c == 0) {
          for (int k = k0; k < k1; ++k, o += N, qc += qrow) {
            put<false>(o, decide<CD, CD0>(qc, ev, e0v, w0, eps), nvalid);
          }
        } else if (tile < N) {
          for (int k = k0; k < k1; ++k, o += N, qc += qrow) {
            put<true>(o, decide<CD, CD0>(qc, ev, e0v, w0, eps), nvalid);
          }
        }
      }
    }
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

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// A launch of the instantiation (CD, CD0): column chunks, queries a query tile, and
// dynamic shared memory (12 warps' lane slots, then the query tile); QT = 0 where one
// query's chunks do not fit.
struct Plan {
  int nc, QT, smem;
};

template <int CD, int CD0>
Plan plan_scan(int Q, int D, int D0) {
  using S = Scan<CD, CD0>;
  int nc = ceil_div(D, CD) > ceil_div(D0, CD0) ? ceil_div(D, CD) : ceil_div(D0, CD0);
  if (nc < 1) nc = 1;
  const int fixed = kWarps * S::kWarpBytes;
  const int64_t query_bytes = static_cast<int64_t>(nc) * S::kQChunk * 4;
  const int64_t fit = (kMaxSmem - fixed) / query_bytes;
  const int QT = static_cast<int>(Q < fit ? Q : fit);
  return {nc, QT, fixed + static_cast<int>(QT * query_bytes)};
}

template <int CD, int CD0>
int launch_scan(const void* q, const void* q0, const void* emb, const void* emb0, void* out,
                int Q, int64_t N, int D, int D0, float eps, cudaStream_t stream) {
  const Plan p = plan_scan<CD, CD0>(Q, D, D0);
  if (p.QT < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dominance_scan_batch_kernel<CD, CD0>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_bt = (N + kWarps * kTileRows - 1) / (kWarps * kTileRows);
  const unsigned grid = static_cast<unsigned>(n_bt < sms ? n_bt : sms);
  kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(q0),
      static_cast<const float*>(emb), static_cast<const float*>(emb0),
      static_cast<uint8_t*>(out), Q, N, D, D0, p.nc, p.QT, eps);
  return static_cast<int>(cudaGetLastError());
}

// The paper's widths (l = 2, d = 2, two multi-GNNs) in registers exactly; any other
// width in chunks of 16 dominance and 8 label columns.
bool paper_widths(int D, int D0) { return D == 18 && D0 == 6; }

int launch_any(const void* q, const void* q0, const void* emb, const void* emb0, void* out, int Q,
               int64_t N, int D, int D0, float eps, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paper_widths(D, D0)) return launch_scan<18, 6>(q, q0, emb, emb0, out, Q, N, D, D0, eps, s);
  return launch_scan<16, 8>(q, q0, emb, emb0, out, Q, N, D, D0, eps, s);
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

// K3-single: q (D,), q0 (D0,), emb (N, D), emb0 (N, D0) -> out (N,): the batch kernel at
// Q = 1.
extern "C" int dominance_scan(const void* q, const void* q0, const void* emb, const void* emb0,
                              void* out, int64_t N, int D, int D0, float eps, void* stream) {
  return launch_any(q, q0, emb, emb0, out, 1, N, D, D0, eps, stream);
}

// K3-batch: q (Q, D), q0 (Q, D0), emb (N, D), emb0 (N, D0) -> out (Q, N).
extern "C" int dominance_scan_batch(const void* q, const void* q0, const void* emb,
                                    const void* emb0, void* out, int Q, int64_t N, int D, int D0,
                                    float eps, void* stream) {
  return launch_any(q, q0, emb, emb0, out, Q, N, D, D0, eps, stream);
}

// The dynamic shared memory, in bytes, of a K3 launch at these sizes (0 where it cannot
// launch): for reports.
extern "C" int dominance_scan_smem(int Q, int D, int D0) {
  const Plan p = paper_widths(D, D0) ? plan_scan<18, 6>(Q, D, D0) : plan_scan<16, 8>(Q, D, D0);
  return p.QT < 1 ? 0 : p.smem;
}
