// The dominance verdicts of the leaf filter: K1 on (query path, data path) pairs and on
// (query path, group bound) pairs, and the dense scans K3-single (one query against N
// rows) and K3-batch (Q queries x N rows).
//
//   pairs:  keep = all_j(q[j] <= e[j] + eps) && all_j(|e0[j] - q0[j]| <= eps)
//   groups: keep = all_j(q[j] <= hi[j] + eps) && all_j(lo0[j] - eps <= q0[j] <= hi0[j] + eps)
//
// Replaces the TPU kernels (src/repro/kernels/dominance_scan/kernel.py)
//   K1         dominance_scan_pairs_kernel / dominance_scan_pairs_pallas  (:90, :98), and
//              the groups form the JAX package builds on it (ops.py, dominance_scan_groups)
//   K3-single  dominance_scan_kernel / dominance_scan_pallas              (:34, :129)
//   K3-batch   dominance_scan_batch_kernel / dominance_scan_batch_pallas  (:44, :58)
// Float32 operands; the output is one byte (0/1) per pair or cell.  No padding to 128
// lanes and no padding or bucketing of T, N or Q: a warp masks its own ragged edge.
// Every form decides each element through the same three comparisons (dominated,
// label_match, within), so their verdicts cannot drift.
//
// K1 is one kernel family: two operand forms x two verdicts, all persistent.
//   * Packed: row-aligned operands (T, D) and (T, D0), as the JAX package's
//     dominance_scan_pairs takes them, and (qg, q0g, hi, lo0, hi0) for the groups
//     verdict, natively (no concatenation, negation or zero column).  Bound: memory;
//     a pair reads 4*(2*D + 2*D0) bytes (pairs) or 4*(2*D + 3*D0) (groups) and writes 1,
//     about 58 us per million pairs at the paper's D = 18, D0 = 6.  Design: K3's
//     streaming pattern made to fit pairs.  A block's warps each walk tiles of 128
//     consecutive pairs, 4 a lane; a warp stages its tile of every operand by cp.async
//     (16-byte granules where an operand starts on 16 bytes, 4-byte words otherwise)
//     into lane slots with an odd stride in granules, so a lane's 16-byte reads of its
//     own 4 rows are conflict free, and decides it from shared memory.  One stage a warp
//     and as many warps as shared memory holds (8) beat 2 or 3 stages with fewer warps:
//     the warps' copies overlap each other's deciding (tools/k1_variants.py).  The
//     paper's widths (18, 6) are one chunk; any other width goes through chunks of 16
//     dominance and 8 label columns whose pads are never compared.
//   * Indexed: the engine's form.  A pair t names a data row (or group) rows[t] and a
//     query row q_ids[t] of its segment: one partition's pack, one delta buffer, or the
//     stacked tables (flat rows).  The kernel reads the indices and the tables where
//     they live, so no operand is gathered, concatenated or written before it.  A
//     segment's descriptor (an int64 row of the table built by ops.segment_layout) holds
//     its index arrays and, for the data and the query side, table 0 and its row
//     stride, table 1, the stride between later tables and their row stride, the labels
//     and their row stride.  A
//     dominance row is N tables of W columns (the paper's 3 x 6: o(p) and two o'(p)),
//     the groups form's data labels (lo0, hi0) interleaved, read in place.  Bound: bytes
//     of the indices, of the distinct data and query rows, and of the verdicts.
//     Design: persistent blocks of 8 warps; a warp takes 32 consecutive pairs, one a
//     lane, so each index load is coalesced and neighbouring pairs of a pack hit
//     neighbouring rows of the same sectors.  One pair a lane beats four at every size
//     the engine makes (66 K to 1.06 M pairs): more warps in flight hide the chain of
//     index, label and row loads better than one lane's four pairs do.  A pair
//     finds its segment by binary search over the segments' first pairs, kept in
//     shared memory with the descriptors up to kSegCap segments and read from device
//     memory beyond.  Labels first: a pair reads its 24-byte label rows, and its
//     dominance rows only if the labels hold; the verdict is an AND of comparisons,
//     so the order changes no bit, NaN included (tools/k1_variants.py times both).  Rows
//     are read as 8-byte vectors where every base and stride allows it (the paper's
//     rows are 24 bytes), by ld.global.nc.  A ballot gives every lane the warp's 32
//     verdicts, and 8 lanes store 4 consecutive bytes each as one 4-byte word.
//     (W, N, D0) = (6, 3, 6) is compiled with the widths as constants; any other width
//     takes the same kernel with the widths read at run time.
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
// as NumPy and JAX compute them (a float32 array against a weak Python scalar); lo0 - eps
// is __fsub_rn(lo0, eps), the bits of the groups reference's lo0 - e.  Build without
// --use_fast_math: flushing denormals to zero could flip a tie.  NaN compares false and
// +inf rows compare as IEEE says, as in the reference.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

__device__ __forceinline__ bool dominated(float q, float e, float eps) {
  return q <= __fadd_rn(e, eps);
}

__device__ __forceinline__ bool label_match(float q0, float e0, float eps) {
  return fabsf(__fsub_rn(e0, q0)) <= eps;
}

// The groups verdict on one label column: q0 inside [lo0 - eps, hi0 + eps].
__device__ __forceinline__ bool within(float q0, float lo0, float hi0, float eps) {
  return (q0 <= __fadd_rn(hi0, eps)) & (q0 >= __fsub_rn(lo0, eps));
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


// ---- K1, packed forms ---------------------------------------------------------

constexpr int kPackedStages = 1;  // a warp's ring of tiles
constexpr int kMaxPackedWarps = 8;

// The layout of a packed instantiation: CD dominance and CD0 label columns a chunk;
// a stage is the lane slots of q and e (or hi), then of q0 and e0 (or lo0 and hi0).
template <int CD, int CD0, bool kGroups>
struct Packed {
  static constexpr int kSlot = slot_granules(CD);
  static constexpr int kSlot0 = slot_granules(CD0);
  static constexpr int kLabelArrays = kGroups ? 3 : 2;
  static constexpr int kStageBytes = 32 * 16 * (2 * kSlot + kLabelArrays * kSlot0);
  static constexpr int kFit = kMaxSmem / (kPackedStages * kStageBytes);
  static constexpr int kWarps = kFit < kMaxPackedWarps ? kFit : kMaxPackedWarps;
  static constexpr int kSmem = kWarps * kPackedStages * kStageBytes;
};

__device__ __forceinline__ uint32_t verdict_word(const bool (&keep)[4]) {
  return static_cast<uint32_t>(keep[0]) | static_cast<uint32_t>(keep[1]) << 8 |
         static_cast<uint32_t>(keep[2]) << 16 | static_cast<uint32_t>(keep[3]) << 24;
}

// One chunk of a lane's 4 staged pairs into `keep`: float f of a slot is row f / CW,
// column f % CW; columns past the chunk's widths w, w0 were never copied and are not
// compared.
template <int CD, int CD0, bool kGroups>
__device__ __forceinline__ void decide_packed(bool (&keep)[4], const float4* stage, int lane,
                                              int w, int w0, float eps) {
  using P = Packed<CD, CD0, kGroups>;
  const float4* qs = stage + lane * P::kSlot;
  const float4* es = stage + (32 + lane) * P::kSlot;
#pragma unroll
  for (int g = 0; g < CD; ++g) {
    const float4 a = qs[g], b = es[g];
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = 4 * g + k;
      if (f % CD < w) keep[f / CD] &= dominated(av[k], bv[k], eps);
    }
  }
  const float4* s0 = stage + 64 * P::kSlot;
  const float4* q0s = s0 + lane * P::kSlot0;
  const float4* l0s = s0 + (32 + lane) * P::kSlot0;
  const float4* h0s = s0 + (64 + lane) * P::kSlot0;  // groups only
#pragma unroll
  for (int g = 0; g < CD0; ++g) {
    const float4 a = q0s[g], b = l0s[g];
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    float cv[4] = {0.f, 0.f, 0.f, 0.f};
    if (kGroups) {
      const float4 c = h0s[g];
      cv[0] = c.x, cv[1] = c.y, cv[2] = c.z, cv[3] = c.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = 4 * g + k;
      if (f % CD0 < w0) {
        keep[f / CD0] &= kGroups ? within(av[k], bv[k], cv[k], eps)
                                 : label_match(av[k], bv[k], eps);
      }
    }
  }
}

// Packed pairs (l0 = e0g, h0 unused) or groups (l0 = lo0, h0 = hi0) -> out (T,); nc
// column chunks.  A warp's jobs are (tile, chunk) in order; job j goes to stage
// j % kPackedStages, and every job commits one copy group, empty or not, so that the
// groups count the jobs.
template <int CD, int CD0, bool kGroups>
__global__ void __launch_bounds__(32 * Packed<CD, CD0, kGroups>::kWarps, 1)
    dominance_scan_packed_kernel(const float* __restrict__ q, const float* __restrict__ e,
                                 const float* __restrict__ q0, const float* __restrict__ l0,
                                 const float* __restrict__ h0, uint8_t* __restrict__ out,
                                 int64_t T, int D, int D0, int nc, float eps) {
  using P = Packed<CD, CD0, kGroups>;
  extern __shared__ __align__(16) unsigned char packed_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* const ring = packed_smem + warp * kPackedStages * P::kStageBytes;
  const int64_t n_tiles = (T + kTileRows - 1) / kTileRows;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * P::kWarps + warp;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * P::kWarps;
  const int64_t n_jobs = (gw < n_tiles ? (n_tiles - gw + nw - 1) / nw : 0) * nc;
  auto stage_of = [&](int64_t j) {
    return reinterpret_cast<float4*>(ring + (j % kPackedStages) * P::kStageBytes);
  };
  auto stage_job = [&](int64_t j) {
    if (j < n_jobs) {
      const int c = static_cast<int>(j % nc);
      const int64_t r0 = (gw + (j / nc) * nw) * kTileRows;
      const int w = width(D - c * CD, CD), w0 = width(D0 - c * CD0, CD0);
      float4* s = stage_of(j);
      stage_rows<CD, P::kSlot>(s, q, T, D, c * CD, w, r0, lane);
      stage_rows<CD, P::kSlot>(s + 32 * P::kSlot, e, T, D, c * CD, w, r0, lane);
      float4* s0 = s + 64 * P::kSlot;
      stage_rows<CD0, P::kSlot0>(s0, q0, T, D0, c * CD0, w0, r0, lane);
      stage_rows<CD0, P::kSlot0>(s0 + 32 * P::kSlot0, l0, T, D0, c * CD0, w0, r0, lane);
      if (kGroups) {
        stage_rows<CD0, P::kSlot0>(s0 + 64 * P::kSlot0, h0, T, D0, c * CD0, w0, r0, lane);
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < kPackedStages; ++j) stage_job(j);
  bool keep[4] = {true, true, true, true};
  for (int64_t j = 0; j < n_jobs; ++j) {
    cp_async_wait<kPackedStages - 1>();
    __syncwarp();  // every lane's copies of job j have landed
    const int c = static_cast<int>(j % nc);
    decide_packed<CD, CD0, kGroups>(keep, stage_of(j), lane, width(D - c * CD, CD),
                                    width(D0 - c * CD0, CD0), eps);
    __syncwarp();  // every lane has read job j's stage: it takes job j + kPackedStages
    stage_job(j + kPackedStages);
    if (c == nc - 1) {
      const int64_t r = (gw + (j / nc) * nw) * kTileRows + 4 * lane;
      const int64_t left = T - r;
      if (left > 0) put<false>(out + r, verdict_word(keep), left < 4 ? static_cast<int>(left) : 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) keep[i] = true;
    }
  }
  cp_async_wait<0>();
}

// Once per instantiation and device: the shared-memory opt-in; once per device: the
// SM count.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];

int sm_count(int device, int* sms) {
  *sms = g_sms[device].load(std::memory_order_relaxed);
  if (*sms > 0) return 0;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_sms[device].store(*sms, std::memory_order_relaxed);
  return 0;
}

template <int CD, int CD0, bool kGroups>
int launch_packed(const float* q, const float* e, const float* q0, const float* l0,
                  const float* h0, uint8_t* out, int64_t T, int D, int D0, float eps, int device,
                  cudaStream_t stream) {
  using P = Packed<CD, CD0, kGroups>;
  auto kernel = dominance_scan_packed_kernel<CD, CD0, kGroups>;
  static std::atomic<int> opted[kMaxDevices];
  if (opted[device].load(std::memory_order_relaxed) == 0) {
    const cudaError_t err = allow_smem(kernel, P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device].store(1, std::memory_order_relaxed);
  }
  int sms = 0;
  if (const int rc = sm_count(device, &sms)) return rc;
  int nc = ceil_div(D, CD) > ceil_div(D0, CD0) ? ceil_div(D, CD) : ceil_div(D0, CD0);
  if (nc < 1) nc = 1;
  const int64_t n_tiles = (T + kTileRows - 1) / kTileRows;
  const int64_t want = (n_tiles + P::kWarps - 1) / P::kWarps;
  const unsigned grid = static_cast<unsigned>(want < sms ? want : sms);
  kernel<<<grid, 32 * P::kWarps, P::kSmem, stream>>>(q, e, q0, l0, h0, out, T, D, D0, nc, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGroups>
int launch_packed_any(const void* q, const void* e, const void* q0, const void* l0,
                      const void* h0, void* out, int64_t T, int D, int D0, float eps, int device,
                      void* stream) {
  if (T <= 0) return 0;
  if (device < 0 || device >= kMaxDevices || D < 1 || D0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paper_widths(D, D0)) {
    return launch_packed<18, 6, kGroups>(f(q), f(e), f(q0), f(l0), f(h0), o, T, D, D0, eps,
                                         device, s);
  }
  return launch_packed<16, 8, kGroups>(f(q), f(e), f(q0), f(l0), f(h0), o, T, D, D0, eps, device,
                                       s);
}

// ---- K1, indexed forms --------------------------------------------------------

constexpr int kSegFields = 16;  // a segment's descriptor, in int64 words (ops.py)
constexpr int kSegCap = 128;    // segments whose descriptors a block keeps in shared memory
constexpr int kIndexedWarps = 8;
constexpr int kIndexedThreads = 32 * kIndexedWarps;
constexpr bool kLabelsFirst = true;  // dominance rows read only where the labels hold

// One side of a segment: row r of table 0 starts at t0 + r * rs0, of table k >= 1 at
// t1 + (k - 1) * ts + r * rs1; its labels at lab + r * lrs.  Strides in floats.
struct Side {
  const float* t0;
  int64_t rs0;
  const float* t1;
  int64_t ts, rs1;
  const float* lab;
  int64_t lrs;
};

__device__ __forceinline__ Side read_side(const int64_t* f) {
  return {reinterpret_cast<const float*>(f[0]), f[1], reinterpret_cast<const float*>(f[2]), f[3],
          f[4], reinterpret_cast<const float*>(f[5]), f[6]};
}

__device__ __forceinline__ const float* table_row(const Side& s, int k, int64_t r) {
  return k == 0 ? s.t0 + r * s.rs0 : s.t1 + (k - 1) * s.ts + r * s.rs1;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The last segment whose first pair is at or before t (empty segments share their
// first pair with the next one and are passed over).
__device__ __forceinline__ int find_segment(const int64_t* starts, int n, int64_t t) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The label test of data row r against query row q: pairs |e0 - q0| <= eps, groups
// lo0 - eps <= q0 <= hi0 + eps with (lo0, hi0) interleaved.  kVec: 8-byte loads.
template <int D0, bool kGroups, bool kVec>
__device__ __forceinline__ bool labels_hold(const Side& es, const Side& qs, int64_t r,
                                            int64_t q, int d0, float eps) {
  const int n0 = D0 ? D0 : d0;
  const float* e0 = es.lab + r * es.lrs;
  const float* q0 = qs.lab + q * qs.lrs;
  bool keep = true;
  if (kVec) {
#pragma unroll
    for (int j = 0; j < n0; j += 2) {
      const float2 a = ld2(q0 + j);
      if (kGroups) {
        const float2 b = ld2(e0 + 2 * j), c = ld2(e0 + 2 * j + 2);
        keep &= within(a.x, b.x, b.y, eps) & within(a.y, c.x, c.y, eps);
      } else {
        const float2 b = ld2(e0 + j);
        keep &= label_match(a.x, b.x, eps) & label_match(a.y, b.y, eps);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < n0; ++j) {
      const float a = __ldg(q0 + j);
      keep &= kGroups ? within(a, __ldg(e0 + 2 * j), __ldg(e0 + 2 * j + 1), eps)
                      : label_match(a, __ldg(e0 + j), eps);
    }
  }
  return keep;
}

// The dominance test of data row r against query row q over N tables of W columns.
template <int W, int N, bool kVec>
__device__ __forceinline__ bool dominance_holds(const Side& es, const Side& qs, int64_t r,
                                                int64_t q, int w_rt, int n_rt, float eps) {
  const int w = W ? W : w_rt, n = N ? N : n_rt;
  bool keep = true;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float* e = table_row(es, k, r);
    const float* qq = table_row(qs, k, q);
    if (kVec) {
#pragma unroll
      for (int c = 0; c < w; c += 2) {
        const float2 a = ld2(qq + c), b = ld2(e + c);
        keep &= dominated(a.x, b.x, eps) & dominated(a.y, b.y, eps);
      }
    } else {
#pragma unroll
      for (int c = 0; c < w; ++c) keep &= dominated(__ldg(qq + c), __ldg(e + c), eps);
    }
  }
  return keep;
}

// Indexed pairs or groups over n_seg segments -> out (T,).  `desc`: the segments' first
// pairs (n_seg + 1 words, the last T), then kSegFields words a segment (ops.py).
// (W, N, D0) nonzero: those widths as constants; 0: w, n, d0 at run time.  A warp's tile
// is 32 consecutive pairs, one a lane.
template <int W, int N, int D0, bool kGroups, bool kVec>
__global__ void __launch_bounds__(kIndexedThreads)
    dominance_scan_indexed_kernel(const int64_t* __restrict__ desc, int n_seg,
                                  uint8_t* __restrict__ out, int64_t T, int w, int n, int d0,
                                  float eps) {
  __shared__ int64_t s_desc[kSegCap + 1 + kSegCap * kSegFields];
  const int64_t* starts = desc;
  const int64_t* fields = desc + n_seg + 1;
  if (n_seg <= kSegCap) {
    const int words = n_seg + 1 + n_seg * kSegFields;
    for (int i = threadIdx.x; i < words; i += kIndexedThreads) s_desc[i] = desc[i];
    __syncthreads();
    starts = s_desc;
    fields = s_desc + n_seg + 1;
  }
  const int lane = threadIdx.x & 31;
  const int64_t n_tiles = (T + 31) / 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kIndexedWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kIndexedWarps + (threadIdx.x >> 5);
       tile < n_tiles; tile += warps) {
    const int64_t t0 = tile * 32;
    // the lane's pair; one past T reads the last pair, unstored
    const int64_t t = t0 + lane < T ? t0 + lane : T - 1;
    const int seg = find_segment(starts, n_seg, t);
    const int64_t* f = fields + seg * kSegFields;
    const int64_t local = t - starts[seg];
    const int64_t r = __ldg(reinterpret_cast<const long long*>(f[0]) + local);
    const int64_t q = __ldg(reinterpret_cast<const long long*>(f[1]) + local);
    const Side es = read_side(f + 2), qs = read_side(f + 9);
    bool keep = labels_hold<D0, kGroups, kVec>(es, qs, r, q, d0, eps);
    if (!kLabelsFirst || keep) keep &= dominance_holds<W, N, kVec>(es, qs, r, q, w, n, eps);
    // lane l < 8 stores pairs t0 + 4l .. 4l + 3: bits 4l .. 4l + 3 of the ballot
    const unsigned nib = __ballot_sync(kAll, keep) >> ((4 * lane) & 31);
    const uint32_t word = (nib & 1u) | (nib >> 1 & 1u) << 8 | (nib >> 2 & 1u) << 16 |
                          (nib >> 3 & 1u) << 24;
    const int64_t p = t0 + 4 * lane;
    if (lane < 8 && p < T) put<false>(out + p, word, T - p < 4 ? static_cast<int>(T - p) : 4);
  }
}

template <int W, int N, int D0, bool kGroups, bool kVec>
int launch_indexed(const int64_t* desc, int n_seg, uint8_t* out, int64_t T, int w, int n, int d0,
                   float eps, int device, cudaStream_t stream) {
  auto kernel = dominance_scan_indexed_kernel<W, N, D0, kGroups, kVec>;
  static std::atomic<int> fit[kMaxDevices];  // blocks an SM holds
  int per_sm = fit[device].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kIndexedThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit[device].store(per_sm, std::memory_order_relaxed);
  }
  int sms = 0;
  if (const int rc = sm_count(device, &sms)) return rc;
  const int64_t n_tiles = (T + 31) / 32;
  const int64_t want = (n_tiles + kIndexedWarps - 1) / kIndexedWarps;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  kernel<<<grid, kIndexedThreads, 0, stream>>>(desc, n_seg, out, T, w, n, d0, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGroups>
int launch_indexed_any(const void* desc, int n_seg, void* out, int64_t T, int w, int n, int d0,
                       int vec, float eps, int device, void* stream) {
  if (T <= 0) return 0;
  if (n_seg < 1 || w < 1 || n < 1 || d0 < 0 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* d = static_cast<const int64_t*>(desc);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 6 && n == 3 && d0 == 6) {  // the paper's: l = 2, d = 2, two multi-GNNs
    if (vec) {
      return launch_indexed<6, 3, 6, kGroups, true>(d, n_seg, o, T, w, n, d0, eps, device,
                                                          s);
    }
    return launch_indexed<6, 3, 6, kGroups, false>(d, n_seg, o, T, w, n, d0, eps, device,
                                                         s);
  }
  return launch_indexed<0, 0, 0, kGroups, false>(d, n_seg, o, T, w, n, d0, eps, device, s);
}

}  // namespace

// K1, packed pairs: qg, eg (T, D), q0g, e0g (T, D0) -> out (T,).  Each entry launches
// on `stream` for operands on CUDA device `device` and returns cudaGetLastError() (0 on
// success).
extern "C" int dominance_scan_pairs(const void* qg, const void* q0g, const void* eg,
                                    const void* e0g, void* out, int64_t T, int D, int D0,
                                    float eps, int device, void* stream) {
  return launch_packed_any<false>(qg, eg, q0g, e0g, nullptr, out, T, D, D0, eps, device, stream);
}

// K1, packed groups: qg, hi (T, D), q0g, lo0, hi0 (T, D0) -> out (T,).
extern "C" int dominance_scan_groups(const void* qg, const void* q0g, const void* hi,
                                     const void* lo0, const void* hi0, void* out, int64_t T, int D,
                                     int D0, float eps, int device, void* stream) {
  return launch_packed_any<true>(qg, hi, q0g, lo0, hi0, out, T, D, D0, eps, device, stream);
}

// K1, indexed pairs (groups = 0) or groups (1): `desc` on the card holds n_seg segments'
// first pairs and descriptors (ops.segment_layout); the rows are n tables of w columns and
// d0 labels; vec = 1 where every base and stride takes 8-byte loads.
extern "C" int dominance_scan_indexed(const void* desc, int n_seg, void* out, int64_t T, int w,
                                      int n, int d0, int groups, int vec, float eps, int device,
                                      void* stream) {
  if (groups) {
    return launch_indexed_any<true>(desc, n_seg, out, T, w, n, d0, vec, eps, device, stream);
  }
  return launch_indexed_any<false>(desc, n_seg, out, T, w, n, d0, vec, eps, device, stream);
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
