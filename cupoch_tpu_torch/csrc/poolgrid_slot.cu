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
// 0.16 ms at 67 TFLOP/s. So the kernel is bound by bytes.
//
// Design: one block per (supertile, cell). The block copies its cell's row
// into shared memory once, so the table streams from device memory exactly
// once a launch, which is the byte bound. It then lists the supertile's
// queries tagged to that cell (about QP / T = 48 at the headline) and
// scores them a warp at a time, four queries per warp, so that each float4
// read from shared memory serves four scores; lanes stride over the slots
// and a shuffle reduction takes the least key. Not done yet: overlapping a
// row's load with the scoring (cp.async or TMA into a second buffer).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kSlotMask = 0xFFF;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 4;  // queries one warp scores together

__device__ __forceinline__ float affine_row(float a, float b, float c,
                                            float d, float x, float y,
                                            float z) {
  // ((a x + b y) + c z) + d, each operation rounded on its own
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                __fmul_rn(c, z)),
      d);
}

__global__ void __launch_bounds__(kThreads)
    slot_kernel(const float* __restrict__ params,
                const float* __restrict__ qpool,
                const float4* __restrict__ table, int* __restrict__ out,
                int CH, int QP, int T, int KC) {
  extern __shared__ float4 smem[];
  float4* row = smem;                                 // [KC]
  int* list = reinterpret_cast<int*>(smem + KC);      // [QP]
  __shared__ int count;

  const int cellrow = blockIdx.x;                     // g * T + cell
  const int g = cellrow / T;
  const int cell = cellrow - g * T;
  const float fcell = static_cast<float>(cell);
  const float* qg = qpool + static_cast<size_t>(g) * CH * QP;
  int* og = out + static_cast<size_t>(g) * QP;

  if (threadIdx.x == 0) count = 0;
  const float4* src = table + static_cast<size_t>(cellrow) * KC;
  for (int k = threadIdx.x; k < KC; k += kThreads) row[k] = src[k];
  __syncthreads();
  for (int q = threadIdx.x; q < QP; q += kThreads) {
    const float tag = qg[3 * QP + q];
    if (tag == fcell) {
      list[atomicAdd(&count, 1)] = q;
    } else if (cell == 0 && tag < 0.f) {
      og[q] = 0;
    }
  }
  __syncthreads();
  const int n = count;

  const float R00 = params[0], R01 = params[1], R02 = params[2];
  const float R10 = params[3], R11 = params[4], R12 = params[5];
  const float R20 = params[6], R21 = params[7], R22 = params[8];
  const float t0 = params[9], t1 = params[10], t2 = params[11];
  const float off = params[13];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int base = warp * kQB; base < n; base += kWarps * kQB) {
    float ex[kQB], ey[kQB], ez[kQB];
    int best[kQB];
#pragma unroll
    for (int j = 0; j < kQB; ++j) {
      ex[j] = ey[j] = ez[j] = 0.f;
      best[j] = INT_MAX;
      if (base + j < n) {
        const int q = list[base + j];
        const float qx = qg[q], qy = qg[QP + q], qz = qg[2 * QP + q];
        ex[j] = __fsub_rn(affine_row(R00, R01, R02, t0, qx, qy, qz),
                          qg[4 * QP + q]);
        ey[j] = __fsub_rn(affine_row(R10, R11, R12, t1, qx, qy, qz),
                          qg[5 * QP + q]);
        ez[j] = __fsub_rn(affine_row(R20, R21, R22, t2, qx, qy, qz),
                          qg[6 * QP + q]);
      }
    }
    for (int k = lane; k < KC; k += 32) {
      const float4 c = row[k];
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
        float s = __fadd_rn(c.w, __fmul_rn(c.x, ex[j]));
        s = __fadd_rn(s, __fmul_rn(c.y, ey[j]));
        s = __fadd_rn(s, __fmul_rn(c.z, ez[j]));
        const int key =
            (__float_as_int(__fadd_rn(s, off)) & ~kSlotMask) | k;
        best[j] = min(best[j], key);
      }
    }
#pragma unroll
    for (int j = 0; j < kQB; ++j) {
      int b = best[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        b = min(b, __shfl_xor_sync(0xffffffffu, b, o));
      if (lane == 0 && base + j < n) og[list[base + j]] = b & kSlotMask;
    }
  }
}

}  // namespace

// Launches the slot kernel on `stream`; returns cudaGetLastError() (0 when
// the launch was accepted). All pointers are device pointers to contiguous
// tensors: params [32] f32, qpool [G, CH, QP] f32, table [G * T, KC, 4] f32
// (16-byte aligned), out [G, QP] int32.
extern "C" int poolgrid_slot_launch(const void* params, const void* qpool,
                                    const void* table, void* out, int G,
                                    int CH, int QP, int T, int KC,
                                    void* stream) {
  const size_t smem =
      static_cast<size_t>(KC) * sizeof(float4) +
      static_cast<size_t>(QP) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_kernel<<<G * T, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(qpool),
      static_cast<const float4*>(table), static_cast<int*>(out), CH, QP, T,
      KC);
  return static_cast<int>(cudaGetLastError());
}
