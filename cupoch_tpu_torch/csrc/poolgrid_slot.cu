// Pooled-grid slot kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_make_slim_kernel` (cupoch_tpu/knn/poolgrid.py:724,
// launched by `_slot_pallas`, :800), in both its GN and its exact variant.
// Scores here are f32 in a single pass, so the exact variant's bf16
// low-order table (`scan_lo`) and its three-pass split have no counterpart:
// one kernel serves both.
//
// What it computes, for every pooled query q of supertile g whose cell tag
// t = qpool[g, 3, q] is >= 0:
//   e    = R q + t_pose - cc(q)                       cell-centred residual
//   s_k  = ((cn_k + cx'_k ex) + cy'_k ey) + cz'_k ez  (= |c_k|^2 - 2 e.c_k)
//   key  = (bits(s_k + off) & ~0xFFF) | k             int32, k < KC
//   out  = (min over k of key) & 0xFFF
// over the KC slots of row g * T + t of the score table. off > max |e|^2
// keeps s_k + off positive, so its bits order like its value; the low 12
// bits carry the slot, which quantises the score and breaks ties toward
// the lower slot, exactly as on the TPU. Empty slots and the pad slots up
// to KC carry cn = 3e18 and never win. Queries with tag -1 (empty pool
// lanes) get slot 0, as in the TPU kernel; the epilogue masks them.
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc does not contract them into FMAs and the kernel agrees bit for bit
// with its plain PyTorch version, `slot_plain` in knn/poolgrid_slot.py.
//
// Layout: the score table is cell-major [C_pad, KC] float4 holding
// (cx', cy', cz', cn) with cx' = -2 cx, so one cell's candidates are one
// contiguous row (24 KB at KC = 1536). qpool is [G, CH, QP] f32 with rows
// (x, y, z, tag, ccx, ccy, ccz, ...). params is [32] f32: R row-major in
// 0-8, t in 9-11, off in 13. The output is [G, QP] int32.
//
// Bound at the headline shapes (1M points in [0,2]^3, radius 0.05:
// C_pad = 32768 cells, KC = 1536, G = 1024 supertiles, QP = 1536): the
// table is 805 MB, the seven qpool rows read 44 MB and the output 6 MB, so
// about 0.86 GB moves a launch, 0.26 ms at 3.35 TB/s. The arithmetic is
// about 1M valid queries x 1512 real slots x 7 f32 operations, 10.6 G,
// 0.16 ms at 67 TFLOP/s. So the bytes bound it. What holds the kernel is
// instruction issue: 9 instructions a (query, slot) visit in the hot loop
// (3 FMUL and 4 FADD rounded apart, the LOP3 that packs the key, the
// IMNMX that keeps the least), about 0.47 ms of issue at the headline.
// Timed on an H100 with the copies taken out, the kernel takes as long as
// it does whole; with the scoring taken out, its copies take the byte
// bound: the scoring holds it, not the rows' arrival.
//
// Design. The earlier design ran one block per (supertile, cell): each
// block loaded its 24 KB row before scoring anything, and the blocks an
// SM held started and loaded in step, so loads and scoring took turns;
// each of a supertile's 32 blocks scanned all of its tags. Here:
// - One block of 8 warps per supertile (2 an SM). It bins the
//   supertile's queries by cell once (a counting sort of the tags in
//   shared memory) and walks the cells that hold a query, in order,
//   skipping the rows of the others.
// - Rows arrive by one `cp.async.bulk` each into a ring of row buffers
//   (as many as fit the block's share of the SM: 4 at KC 1536; at least
//   2, at most 8), completed on mbarriers: later rows are in flight while
//   the current one is scored, and no thread spends instructions on the
//   copy.
// - A cell's queries form groups of 8 (the last of 1-8); the supertile's
//   groups go to its warps in turn, so the ragged groups of consecutive
//   cells land on different warps. A warp scores a group's 8 queries
//   together (4 for a group of at most 4), so each float4 read from
//   shared memory serves 8 visits; the least key of each query ends in
//   one `redux.sync`.
// - No block-wide barrier between cells: a warp that is done with a row
//   adds one to the buffer's count, and the warp that completes the count
//   starts the copy of the row nrows cells on. A warp waits for each row
//   in turn (also when it holds no group of that cell), so no warp gets
//   nrows rows ahead and the counts of a buffer's uses never interleave.
// Tried on the card and left out, each slower than the full-row scan
// although each scores fewer slots: an empty slot (c' = 0, cn = 3e18)
// scores cn for every query, and about a third of the headline's slots
// are empty, so a warp could score the live slots and one empty
// stand-in. Compacting each landed row in shared memory (by the warp
// that claims it, or by producer warps) put a long serial chain on one
// warp a row; a per-warp map of the live slots made each row read wait
// on a map read; looping over the 27 runs' live lengths broke the
// loop's software pipelining. The regular loop over all KC slots, its
// addresses from its counter, issues best.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kSlotMask = 0xFFF;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocks = 2;         // blocks an SM should hold; caps registers
constexpr int kGroup = 8;          // queries one warp scores together
constexpr int kMaxTile = 64;       // cells a supertile may hold
constexpr int kMaxRows = 8;        // row buffers at most
// shared memory of an SM that a block's row ring and query list may
// take: the SM's 228 KB over kBlocks, less the static part and the 1 KB
// the runtime reserves a block
constexpr size_t kBlockSmem = 228 * 1024 / kBlocks - 3 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// waits until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one thread: copies `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global memory into shared memory with one bulk copy that
// completes the current phase of `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float affine_row(float a, float b, float c,
                                            float d, float x, float y,
                                            float z) {
  // ((a x + b y) + c z) + d, each operation rounded on its own
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                __fmul_rn(c, z)),
      d);
}

// The cells of a supertile that hold a query, in cell order: the cell,
// where its queries start in the binned list, how many, and the index of
// its first group among the supertile's groups (`gbase[n]` is the total).
struct Cells {
  int cell[kMaxTile];
  int start[kMaxTile];
  int count[kMaxTile];
  int gbase[kMaxTile + 1];
  int n;
};

// Scores the m <= Q queries qlist[q0 .. q0 + m) of one cell against the
// KC slots of its row and writes their slots. Lane j < m transforms query
// j and shares its residual with the warp.
template <int Q>
__device__ __forceinline__ void score_group(const float4* row, int KC,
                                            const uint16_t* qlist, int q0,
                                            int m, const float* qg, int QP,
                                            const float* P, float off,
                                            int* og, int lane) {
  float mx = 0.f, my = 0.f, mz = 0.f;
  int q = 0;
  if (lane < m) {
    q = qlist[q0 + lane];
    const float qx = qg[q], qy = qg[QP + q], qz = qg[2 * QP + q];
    mx = __fsub_rn(affine_row(P[0], P[1], P[2], P[9], qx, qy, qz),
                   qg[4 * QP + q]);
    my = __fsub_rn(affine_row(P[3], P[4], P[5], P[10], qx, qy, qz),
                   qg[5 * QP + q]);
    mz = __fsub_rn(affine_row(P[6], P[7], P[8], P[11], qx, qy, qz),
                   qg[6 * QP + q]);
  }
  float ex[Q], ey[Q], ez[Q];
  int best[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    ex[j] = __shfl_sync(kFull, mx, j);
    ey[j] = __shfl_sync(kFull, my, j);
    ez[j] = __shfl_sync(kFull, mz, j);
    best[j] = INT_MAX;
  }
#pragma unroll 4
  for (int k = lane; k < KC; k += 32) {
    const float4 c = row[k];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      float s = __fadd_rn(c.w, __fmul_rn(c.x, ex[j]));
      s = __fadd_rn(s, __fmul_rn(c.y, ey[j]));
      s = __fadd_rn(s, __fmul_rn(c.z, ez[j]));
      const int key = (__float_as_int(__fadd_rn(s, off)) & ~kSlotMask) | k;
      best[j] = min(best[j], key);
    }
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int b = __reduce_min_sync(kFull, best[j]);
    if (lane == j) mine = b;
  }
  if (lane < m) og[q] = mine & kSlotMask;
}

__global__ void __launch_bounds__(kThreads, kBlocks)
    slot_kernel(const float* __restrict__ params,
                const float* __restrict__ qpool,
                const float4* __restrict__ table, int* __restrict__ out,
                int CH, int QP, int T, int KC, int nrows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);            // [nrows, KC]
  // the binned query list, as 16-bit lane numbers (QP <= 65536)
  uint16_t* qlist = reinterpret_cast<uint16_t*>(rows + nrows * KC);
  __shared__ uint64_t full[kMaxRows];
  __shared__ int done[kMaxRows];
  __shared__ int fill[kMaxTile];
  __shared__ Cells cl;
  __shared__ float P[16];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* qg = qpool + static_cast<size_t>(g) * CH * QP;
  int* og = out + static_cast<size_t>(g) * QP;
  const float4* src = table + static_cast<size_t>(g) * T * KC;
  const unsigned row_bytes = static_cast<unsigned>(KC) * sizeof(float4);

  if (tid < T) fill[tid] = 0;
  if (tid < 16) P[tid] = params[tid];
  if (tid < nrows) {
    mbar_init(&full[tid], 1);
    done[tid] = 0;
  }
  if (tid == 0)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // 1. count the queries of each cell; empty pool lanes get slot 0
  for (int q = tid; q < QP; q += kThreads) {
    const float tag = qg[3 * QP + q];
    if (tag < 0.f) {
      og[q] = 0;
    } else if (tag < static_cast<float>(T)) {
      atomicAdd(&fill[static_cast<int>(tag)], 1);
    }
  }
  __syncthreads();

  // 2. the cells that hold a query, their offsets and groups; the first
  // rows start on their way
  if (tid == 0) {
    int s = 0, groups = 0, n = 0;
    for (int t = 0; t < T; ++t) {
      const int c = fill[t];
      fill[t] = s;
      if (c > 0) {
        cl.cell[n] = t;
        cl.start[n] = s;
        cl.count[n] = c;
        cl.gbase[n] = groups;
        groups += (c + kGroup - 1) / kGroup;
        ++n;
      }
      s += c;
    }
    cl.gbase[n] = groups;
    cl.n = n;
    for (int i = 0; i < nrows && i < n; ++i)
      bulk_load(rows + i * KC, src + static_cast<size_t>(cl.cell[i]) * KC,
                row_bytes, &full[i]);
  }
  __syncthreads();

  // 3. list the queries by cell (order within a cell is free: each
  // query's slot depends on it alone)
  for (int q = tid; q < QP; q += kThreads) {
    const float tag = qg[3 * QP + q];
    if (tag >= 0.f && tag < static_cast<float>(T))
      qlist[atomicAdd(&fill[static_cast<int>(tag)], 1)] =
          static_cast<uint16_t>(q);
  }
  __syncthreads();

  // 4. score: cell i's row is in buffer i % nrows, its use i / nrows
  const float off = P[13];
  const int n = cl.n;
  int grp = warp;                    // the next group this warp takes
  for (int i = 0; i < n; ++i) {
    const int b = i % nrows;
    mbar_wait(&full[b], (i / nrows) & 1);
    const float4* row = rows + b * KC;
    const int g0 = cl.gbase[i];
    for (; grp < cl.gbase[i + 1]; grp += kWarps) {
      const int local = (grp - g0) * kGroup;
      const int m = min(kGroup, cl.count[i] - local);
      if (m > kGroup / 2)
        score_group<kGroup>(row, KC, qlist, cl.start[i] + local, m, qg, QP,
                            P, off, og, lane);
      else
        score_group<kGroup / 2>(row, KC, qlist, cl.start[i] + local, m, qg,
                                QP, P, off, og, lane);
    }
    // done with this row: the warp that completes the buffer's count
    // starts the row nrows cells on into it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int seen = atomicAdd(&done[b], 1);
      if (seen == kWarps * (i / nrows + 1) - 1 && i + nrows < n)
        bulk_load(rows + b * KC,
                  src + static_cast<size_t>(cl.cell[i + nrows]) * KC,
                  row_bytes, &full[b]);
    }
  }
}

// Row buffers a block keeps: as many as fit its share of the SM beside
// its query list (at least 2, at most kMaxRows).
int row_buffers(int QP, int KC) {
  const size_t row = static_cast<size_t>(KC) * sizeof(float4);
  const size_t list = static_cast<size_t>(QP) * sizeof(uint16_t);
  const size_t fit = kBlockSmem > list ? (kBlockSmem - list) / row : 0;
  return static_cast<int>(fit < 2 ? 2 : (fit > kMaxRows ? kMaxRows : fit));
}

size_t dynamic_smem(int QP, int KC) {
  return row_buffers(QP, KC) * static_cast<size_t>(KC) * sizeof(float4) +
         static_cast<size_t>(QP) * sizeof(uint16_t);
}

}  // namespace

// Launches the slot kernel on `stream`; returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue (1) for a supertile
// of more than 64 cells or more than 65536 pooled queries. All pointers
// are device pointers to contiguous tensors: params [32] f32, qpool
// [G, CH, QP] f32, table [G * T, KC, 4] f32 (16-byte aligned), out
// [G, QP] int32.
extern "C" int poolgrid_slot_launch(const void* params, const void* qpool,
                                    const void* table, void* out, int G,
                                    int CH, int QP, int T, int KC,
                                    void* stream) {
  if (T > kMaxTile || QP > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dynamic_smem(QP, KC);
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(qpool),
      static_cast<const float4*>(table), static_cast<int*>(out), CH, QP, T,
      KC, row_buffers(QP, KC));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the slot kernel that one SM holds at once at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA
// error; `warps` gets the warps a block.
extern "C" int poolgrid_slot_occupancy(int QP, int KC, int* warps) {
  const size_t smem = dynamic_smem(QP, KC);
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, slot_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *warps = kWarps;
  return blocks;
}
