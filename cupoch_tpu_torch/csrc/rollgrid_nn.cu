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
// `nn_reduce_plain` in knn/rollgrid_nn.py. Empty candidate slots hold
// 3e18 and empty query slots 1e18 in every coordinate: their squares stay
// finite in f32 and far above any r2 (the wrapper refuses r2 >= 1e30), so
// an empty query slot gets (-1, +inf) at once, exactly what the arithmetic
// would give it, and empty candidate lanes never win.
//
// Layout: q_soa [C, 3, qcap] f32, cand [C, 3, KC] f32, cidx [C, KC] int32,
// outputs idx [C, qcap] int32 and d2 [C, qcap] f32.
//
// Bound: the work depends on the data. A cell without a query needs only
// its query rows read and its outputs written; a cell with one must read
// its whole candidate row (16 bytes a lane: the 27 runs interleave empty
// slots with real ones, so no lane can be skipped unread) and do about 8
// f32 operations per (query, lane). At the roll plan of 1M points in
// [0,1.4]^3 (27 000 cells, 24 211 of them busy, qcap 64, KC 1792) that is
// about 0.72 GB (0.22 ms at 3.35 TB/s) and 14.3 G operations (0.21 ms at
// 67 TFLOP/s): about as much by bytes as by operations.
//
// Design: one block per cell. The block lists its cell's valid queries and
// writes (-1, +inf) to the empty slots; a cell with no valid query returns
// before it reads a candidate (most slots of the cell grid hold none). A
// busy cell stages its row in shared memory once, as four SoA arrays (x,
// y, z, index: 16 bytes a lane, 28 KB at KC 1792), so the row streams from
// device memory once. Each warp then scores four queries at a time: its
// lanes stride over the candidates, every shared-memory read serves the
// four queries, each lane keeps a running (d2, index) per query, and one
// shuffle reduction with the same tie rule ends each group. Not done yet:
// overlapping the row load with scoring (cp.async or TMA), and packing
// several small cells into one block for the cell grid's qcap of 8.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kQB = 4;                  // queries one warp scores together
constexpr int kMaxWarps = 4;
constexpr float kQueryFill = 1.0e18f;   // empty query slot

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    nn_kernel(const float* __restrict__ q_soa,
              const float* __restrict__ cand, const int* __restrict__ cidx,
              int* __restrict__ out_idx, float* __restrict__ out_d2,
              float r2, int qcap, int KC) {
  extern __shared__ float smem[];
  float* sx = smem;                                   // [KC]
  float* sy = sx + KC;                                // [KC]
  float* sz = sy + KC;                                // [KC]
  int* si = reinterpret_cast<int*>(sz + KC);          // [KC]
  int* list = si + KC;                                // [qcap]
  __shared__ int count;

  const size_t cell = blockIdx.x;
  const float* q = q_soa + cell * 3 * qcap;
  int* oi = out_idx + cell * qcap;
  float* od = out_d2 + cell * qcap;
  const float inf = __int_as_float(0x7f800000);

  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < qcap; s += blockDim.x) {
    if (q[s] == kQueryFill) {
      oi[s] = -1;
      od[s] = inf;
    } else {
      list[atomicAdd(&count, 1)] = s;
    }
  }
  __syncthreads();
  const int n = count;
  if (n == 0) return;          // uniform across the block

  const float* c = cand + cell * 3 * KC;
  const int* ci = cidx + cell * KC;
  for (int k = threadIdx.x; k < KC; k += blockDim.x) {
    sx[k] = c[k];
    sy[k] = c[KC + k];
    sz[k] = c[2 * KC + k];
    si[k] = ci[k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int base = warp * kQB; base < n; base += n_warps * kQB) {
    float qx[kQB], qy[kQB], qz[kQB], bd[kQB];
    int bi[kQB];
#pragma unroll
    for (int j = 0; j < kQB; ++j) {
      const int s = list[min(base + j, n - 1)];
      qx[j] = q[s];
      qy[j] = q[qcap + s];
      qz[j] = q[2 * qcap + s];
      bd[j] = inf;
      bi[j] = INT_MAX;
    }
    for (int k = lane; k < KC; k += 32) {
      const float cx = sx[k], cy = sy[k], cz = sz[k];
      const int ck = si[k];
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
        const float dx = __fsub_rn(qx[j], cx);
        const float dy = __fsub_rn(qy[j], cy);
        const float dz = __fsub_rn(qz[j], cz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (better(d2, ck, bd[j], bi[j])) {
          bd[j] = d2;
          bi[j] = ck;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQB; ++j) {
      float d = bd[j];
      int i = bi[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float d_o = __shfl_xor_sync(0xffffffffu, d, o);
        const int i_o = __shfl_xor_sync(0xffffffffu, i, o);
        if (better(d_o, i_o, d, i)) {
          d = d_o;
          i = i_o;
        }
      }
      if (lane == 0 && base + j < n) {
        const int s = list[base + j];
        const bool ok = d <= r2;
        oi[s] = ok ? i : -1;
        od[s] = ok ? d : inf;
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream`, one block per cell; returns
// cudaGetLastError() (0 when the launch was accepted). All pointers are
// device pointers to contiguous tensors: q_soa [C, 3, qcap] f32, cand
// [C, 3, KC] f32, cidx [C, KC] int32, idx [C, qcap] int32, d2 [C, qcap] f32.
extern "C" int rollgrid_nn_launch(const void* q_soa, const void* cand,
                                  const void* cidx, void* idx, void* d2,
                                  float r2, int C, int qcap, int KC,
                                  void* stream) {
  if (C == 0 || qcap == 0) return 0;
  const size_t smem = static_cast<size_t>(KC) * 4 * sizeof(float) +
                      static_cast<size_t>(qcap) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = (qcap + kQB - 1) / kQB;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  nn_kernel<<<C, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_soa), static_cast<const float*>(cand),
      static_cast<const int*>(cidx), static_cast<int*>(idx),
      static_cast<float*>(d2), r2, qcap, KC);
  return static_cast<int>(cudaGetLastError());
}
