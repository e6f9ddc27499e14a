// Nearest-candidate reduce of the roll and cell grids for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel `_nn_reduce_kernel` (cupoch_tpu/knn/rollgrid.py:215,
// launched by `_nn_reduce_pallas`, :237), which serves both
// `query_nn_rollgrid` and `cellgrid.query_nn_cellgrid`.
//
// What it computes, for every cell c and query slot s of that cell:
//   d2_k = (dx dx + dy dy) + dz dz,  d = q_s - cand_k,  over all KC lanes k
//   bd2  = min_k d2_k;  idx = least cidx_k over the lanes with d2_k == bd2
//   out  = (idx, bd2) if bd2 <= r2, else (-1, +inf)
// which is the TPU kernel's masked argmin with its tie rule (the smallest
// target index among the lanes at the least distance). Every multiply and
// add is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), in the
// plain version's order, so the kernel agrees bit for bit with
// `nn_reduce_plain` in knn/rollgrid_nn.py. Empty candidate lanes (cidx -1)
// hold 3e18 and empty query slots 1e18 in every coordinate: their squared
// distances stay finite in f32 and far above any r2 (the wrapper refuses
// r2 >= 1e30), so an empty lane can win only when a row holds no real
// lane, and then the answer is (-1, +inf) whatever it scores. The kernel
// therefore scores real lanes only, and gives an empty query slot
// (-1, +inf) at once, exactly what the arithmetic would give it.
//
// Layout: q_soa [C, 3, qcap] f32, cand [C, 3, KC] f32, cidx [C, KC] int32,
// rank [C, KC] int16 (the position of each lane when its row is ordered
// by cidx with the empty lanes last: `lane_rank` in knn/rollgrid_nn.py,
// kept beside the grid), outputs idx [C, qcap] int32 and d2 [C, qcap] f32.
//
// Bound: the work depends on the data. A cell without a query needs only
// its first query channel read and its outputs written; a cell with one
// must read every lane's index, the coordinates of its real lanes and its
// query rows, and do 8 f32 operations per (valid query, real lane). At
// the roll plan of 1M points in [0,1.4]^3 (27 000 cells, 24 211 busy,
// qcap 64, KC 1792, about 1 230 real lanes in an inner row) that is about
// 0.5 GB and 10 G operations, 0.15 ms either way on this card; the kernel
// is bounded by instruction issue, not by either.
//
// Design. Issue: the 8 rounded operations of a (query, lane) are the
// floor, as they cannot fuse. The earlier design spent 6 more on the
// two-key tie test in the hot loop and scored the empty lanes too. Here a
// row is staged in shared memory in ascending cidx order (one float4 a
// real lane: x, y, z, cidx), scattered there through the stored rank, so
// the empty lanes fall off the end and each thread meets its lanes in
// ascending cidx: a strict d2 < best then keeps the least index among the
// thread's ties (3 instructions: 11.6 a visit with the loop). The warp
// then takes the least d2 over its lanes with one integer min reduction
// on the bits of d2 (non-negative floats order as their bits) and the
// least index among the lanes that hold it with a second. A warp scores
// up to 8 queries at a time from registers, so one shared-memory read
// serves 8 of them, and a block splits its cell's valid queries evenly
// over its warps, the last group of a warp as small as it needs to be (no
// padded query is scored). The staging loads go out in batches of 8 lanes
// a thread. Two launch shapes:
// - large rows (the roll grid: qcap 64, KC 1792): one block of 4 warps
//   per cell, 7 blocks an SM (28 KB of shared memory each);
// - small rows (qcap <= 32, KC <= 512: the cell grid's qcap 8, KC 256):
//   persistent warps, as many as the card holds, each walking the cells
//   one at a time with its own 4 KB row; a warp that meets an empty cell
//   (70% of a surface scan's slots) goes straight on, its queries are read
//   two cells ahead and held one a lane, and no block waits for its
//   slowest cell (the earlier one-block-per-cell launch made 672 904
//   blocks of 2 warps).
// Either way a cell without a valid query returns before it reads a
// candidate.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kQB = 8;                  // most queries one warp scores together
constexpr int kSlotQB = 4;              // the same in the slot kernel
constexpr int kCellWarps = 4;           // warps of a cell block
constexpr int kSlotWarps = 8;           // warps of a slot block
constexpr int kSlotMaxQcap = 32;
constexpr int kSlotMaxKC = 512;
constexpr float kQueryFill = 1.0e18f;   // empty query slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Stages the real lanes of one row into `row`, at their rank, as float4
// (x, y, z, cidx bits); thread t of `step` takes lanes t, t + step, ...
// Returns the number of real lanes this thread staged.
template <int kBatch>
__device__ __forceinline__ int stage_row(float4* __restrict__ row,
                                         const float* __restrict__ c,
                                         const int* __restrict__ ci,
                                         const short* __restrict__ rk, int KC,
                                         int t, int step) {
  int staged = 0;
  for (int k0 = t; k0 < KC; k0 += kBatch * step) {
    int i[kBatch], r[kBatch];
    float x[kBatch], y[kBatch], z[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = k0 + b * step;
      i[b] = -1;
      r[b] = 0;
      if (k < KC) {
        i[b] = ci[k];
        r[b] = rk[k];
        x[b] = c[k];
        y[b] = c[KC + k];
        z[b] = c[2 * KC + k];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i[b] >= 0) {
        row[r[b]] = make_float4(x[b], y[b], z[b], __int_as_float(i[b]));
        ++staged;
      }
    }
  }
  return staged;
}

// Query slot s of a cell read from its rows q [3, qcap] in global memory.
struct FromRows {
  const float* q;
  int qcap;
  __device__ __forceinline__ void operator()(int s, float& x, float& y,
                                             float& z) const {
    x = q[s];
    y = q[qcap + s];
    z = q[2 * qcap + s];
  }
};

// Query slot s of a cell held by lane s of the warp (every lane calls).
struct FromLanes {
  float x, y, z;
  __device__ __forceinline__ void operator()(int s, float& qx, float& qy,
                                             float& qz) const {
    qx = __shfl_sync(kFull, x, s);
    qy = __shfl_sync(kFull, y, s);
    qz = __shfl_sync(kFull, z, s);
  }
};

// Scores the Q query slots `slots` against the `n_real` staged lanes of
// `row` with the whole warp and writes their results.
template <int Q, class Queries>
__device__ __forceinline__ void score(const float4* __restrict__ row,
                                      int n_real, const Queries& queries,
                                      const int* __restrict__ slots,
                                      int* __restrict__ oi,
                                      float* __restrict__ od, float r2) {
  const int lane = threadIdx.x & 31;
  float qx[Q], qy[Q], qz[Q], bd[Q];
  int bi[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    queries(slots[j], qx[j], qy[j], qz[j]);
    bd[j] = inf_f();
    bi[j] = INT_MAX;
  }
  // ascending cidx along k: a strict < keeps the least index of a tie
#pragma unroll 1
  for (int k = lane; k < n_real; k += 32) {
    const float4 c = row[k];
    const int ck = __float_as_int(c.w);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float dx = __fsub_rn(qx[j], c.x);
      const float dy = __fsub_rn(qy[j], c.y);
      const float dz = __fsub_rn(qz[j], c.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < bd[j]) {
        bd[j] = d2;
        bi[j] = ck;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    // d2 >= +0, so its bits order as the floats: the least (d2, index)
    const unsigned d = __float_as_uint(bd[j]);
    const unsigned m = __reduce_min_sync(kFull, d);
    const unsigned i = __reduce_min_sync(
        kFull, d == m ? static_cast<unsigned>(bi[j]) : 0xffffffffu);
    if (lane == j) {
      const int s = slots[j];
      const float dm = __uint_as_float(m);
      const bool ok = dm <= r2;
      oi[s] = ok ? static_cast<int>(i) : -1;
      od[s] = ok ? dm : inf_f();
    }
  }
}

// The warp's queries slots[0..n), at most kMax at a time.
template <int kMax, class Queries>
__device__ __forceinline__ void score_all(const float4* row, int n_real,
                                          const Queries& queries,
                                          const int* slots, int n, int* oi,
                                          float* od, float r2) {
  for (int lo = 0; lo < n; lo += kMax) {
    const int* s = slots + lo;
    switch (min(kMax, n - lo)) {
#define NN_CASE(k)                                                   \
  case k:                                                            \
    score<(kMax < k ? kMax : k)>(row, n_real, queries, s, oi, od, r2); \
    break;
      NN_CASE(8) NN_CASE(7) NN_CASE(6) NN_CASE(5)
      NN_CASE(4) NN_CASE(3) NN_CASE(2)
#undef NN_CASE
      default: score<1>(row, n_real, queries, s, oi, od, r2); break;
    }
  }
}

// One block per cell (large rows).
__global__ void __launch_bounds__(kCellWarps * 32, 7)
    nn_cell_kernel(const float* __restrict__ q_soa,
                   const float* __restrict__ cand,
                   const int* __restrict__ cidx,
                   const short* __restrict__ rank, int* __restrict__ out_idx,
                   float* __restrict__ out_d2, float r2, int qcap, int KC) {
  extern __shared__ float4 row[];                         // [KC]
  int* list = reinterpret_cast<int*>(row + KC);           // [qcap]
  __shared__ int count, n_real;

  const size_t cell = blockIdx.x;
  const float* q = q_soa + cell * 3 * qcap;
  int* oi = out_idx + cell * qcap;
  float* od = out_d2 + cell * qcap;

  if (threadIdx.x == 0) {
    count = 0;
    n_real = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < qcap; s += blockDim.x) {
    if (q[s] == kQueryFill) {
      oi[s] = -1;
      od[s] = inf_f();
    } else {
      list[atomicAdd(&count, 1)] = s;
    }
  }
  __syncthreads();
  const int n = count;
  if (n == 0) return;          // uniform across the block

  const int staged = __reduce_add_sync(
      kFull, stage_row<8>(row, cand + cell * 3 * KC, cidx + cell * KC,
                          rank + cell * KC, KC, threadIdx.x, blockDim.x));
  if ((threadIdx.x & 31) == 0 && staged) atomicAdd(&n_real, staged);
  __syncthreads();

  // the valid queries split evenly over the warps (results do not depend
  // on the split: each is an exact lexicographic minimum)
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lo = warp * n / warps;
  score_all<kQB>(row, n_real, FromRows{q, qcap}, list + lo,
                 (warp + 1) * n / warps - lo, oi, od, r2);
}

// Small rows (qcap <= 32): one warp per cell at a time, each warp walking
// the cells gridDim.x * kSlotWarps apart, so a warp that meets an empty
// cell (most cells of a surface scan) goes straight on to the next, and
// no block waits for its slowest cell. Lane s holds query slot s, read
// two cells ahead; the scoring takes the queries from the lanes.
__global__ void __launch_bounds__(kSlotWarps * 32, 4)
    nn_slot_kernel(const float* __restrict__ q_soa,
                   const float* __restrict__ cand,
                   const int* __restrict__ cidx,
                   const short* __restrict__ rank, int* __restrict__ out_idx,
                   float* __restrict__ out_d2, float r2, int C, int qcap,
                   int KC) {
  extern __shared__ float4 rows[];                        // [kSlotWarps, KC]
  __shared__ int lists[kSlotWarps][kSlotMaxQcap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* row = rows + static_cast<size_t>(warp) * KC;
  int* list = lists[warp];
  const bool in = lane < qcap;
  const size_t n_cells = static_cast<size_t>(C);
  const size_t step = static_cast<size_t>(gridDim.x) * kSlotWarps;
  auto load = [&](size_t c, FromLanes& h) {
    h.x = h.y = h.z = kQueryFill;
    if (c < n_cells && in) {
      const float* q = q_soa + c * 3 * qcap + lane;
      h.x = q[0];
      h.y = q[qcap];
      h.z = q[2 * qcap];
    }
  };
  size_t cell = static_cast<size_t>(blockIdx.x) * kSlotWarps + warp;
  FromLanes next, after;
  load(cell, next);
  load(cell + step, after);
  for (; cell < n_cells; cell += step) {
    const FromLanes cur = next;
    next = after;
    load(cell + 2 * step, after);
    int* oi = out_idx + cell * qcap;
    float* od = out_d2 + cell * qcap;
    const bool valid = in && cur.x != kQueryFill;
    if (in && !valid) {
      oi[lane] = -1;
      od[lane] = inf_f();
    }
    const unsigned vm = __ballot_sync(kFull, valid);
    if (vm == 0) continue;
    if (valid) list[__popc(vm & ((1u << lane) - 1u))] = lane;
    const int n_real = __reduce_add_sync(
        kFull, stage_row<4>(row, cand + cell * 3 * KC, cidx + cell * KC,
                            rank + cell * KC, KC, lane, 32));
    __syncwarp();
    score_all<kSlotQB>(row, n_real, cur, list, __popc(vm), oi, od, r2);
    __syncwarp();              // row and list serve the warp's next cell
  }
}

struct Launch {
  const void* fn;
  bool slots;                 // the slot kernel, else one block a cell
  int threads;
  size_t smem;
};

Launch launch_for(int qcap, int KC) {
  if (qcap <= kSlotMaxQcap && KC <= kSlotMaxKC)
    return {reinterpret_cast<const void*>(nn_slot_kernel), true,
            kSlotWarps * 32,
            static_cast<size_t>(kSlotWarps) * KC * sizeof(float4)};
  int warps = (qcap + kQB - 1) / kQB;
  warps = warps < 1 ? 1 : (warps > kCellWarps ? kCellWarps : warps);
  return {reinterpret_cast<const void*>(nn_cell_kernel), false, warps * 32,
          static_cast<size_t>(KC) * sizeof(float4) +
              static_cast<size_t>(qcap) * sizeof(int)};
}

// Sets the launch's shared-memory limit; with `per_sm`, also the blocks
// one SM holds at once.
cudaError_t prepare(const Launch& l, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess || per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, l.fn,
                                                       l.threads, l.smem);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 when the
// launch was accepted). All pointers are device pointers to contiguous
// tensors: q_soa [C, 3, qcap] f32, cand [C, 3, KC] f32, cidx [C, KC]
// int32, rank [C, KC] int16, idx [C, qcap] int32, d2 [C, qcap] f32.
extern "C" int rollgrid_nn_launch(const void* q_soa, const void* cand,
                                  const void* cidx, const void* rank,
                                  void* idx, void* d2, float r2, int C,
                                  int qcap, int KC, void* stream) {
  if (C == 0 || qcap == 0) return 0;
  const Launch l = launch_for(qcap, KC);
  int per_sm = 0;
  cudaError_t err = prepare(l, l.slots ? &per_sm : nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qp = static_cast<const float*>(q_soa);
  const auto* cp = static_cast<const float*>(cand);
  const auto* ip = static_cast<const int*>(cidx);
  const auto* rp = static_cast<const short*>(rank);
  auto* oi = static_cast<int*>(idx);
  auto* od = static_cast<float*>(d2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!l.slots) {
    nn_cell_kernel<<<C, l.threads, l.smem, s>>>(qp, cp, ip, rp, oi, od, r2,
                                                qcap, KC);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the card holds at once, each warp walking its cells
  const long long need = (static_cast<long long>(C) + kSlotWarps - 1) /
                         kSlotWarps;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < fit ? need : fit);
  nn_slot_kernel<<<blocks, l.threads, l.smem, s>>>(qp, cp, ip, rp, oi, od,
                                                   r2, C, qcap, KC);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel `rollgrid_nn_launch` picks for (qcap, KC) that one
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative CUDA error; `warps` gets the warps a block.
extern "C" int rollgrid_nn_occupancy(int qcap, int KC, int* warps) {
  const Launch l = launch_for(qcap, KC);
  int blocks = 0;
  const cudaError_t err = prepare(l, &blocks);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *warps = l.threads / 32;
  return blocks;
}
