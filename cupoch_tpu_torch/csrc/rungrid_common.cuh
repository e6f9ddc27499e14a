// Run-grid helpers shared by rungrid_fused.cu and rungrid_gmm.cu: the
// score path that makes both kernels agree bit for bit with their plain
// PyTorch versions, and the staging of a cell's candidate row.
//
// Every multiply and add of the query transform and the cell centre is
// rounded on its own (__fmul_rn/__fadd_rn) in the plain version's order,
// so nvcc cannot contract them into FMAs.
#pragma once

#include <cuda_runtime.h>

namespace rungrid {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 128;

__device__ __forceinline__ float affine_row(float a, float b, float c,
                                            float d, float x, float y,
                                            float z) {
  // ((a x + b y) + c z) + d, each operation rounded on its own
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)),
                __fmul_rn(c, z)),
      d);
}

__device__ __forceinline__ float cell_centre(int idx, float origin,
                                             float cell) {
  return __fadd_rn(origin,
                   __fmul_rn(__fadd_rn(static_cast<float>(idx), 0.5f), cell));
}

// The pose (params 0-11) and the centre of row `cell` (params 13-16);
// rows past the C real cells take the last cell's centre.
struct Frame {
  float R[9], t[3];
  float ccx, ccy, ccz;

  __device__ __forceinline__ Frame(const float* params, int cell, int Gx,
                                   int Gy, int Gz) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = params[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = params[9 + i];
    const int lin = min(cell, Gx * Gy * Gz - 1);
    ccx = cell_centre(lin / (Gz * Gy), params[13], params[16]);
    ccy = cell_centre((lin / Gz) % Gy, params[14], params[16]);
    ccz = cell_centre(lin % Gz, params[15], params[16]);
  }
};

// One query under the pose: t = R q + t_pose (world), e = t - cc, qn =
// |e|^2 in the plain version's order, dqc = |e|.
struct Query {
  float tx, ty, tz, ex, ey, ez, qn, dqc;

  __device__ __forceinline__ Query(const Frame& f, float qx, float qy,
                                   float qz) {
    tx = affine_row(f.R[0], f.R[1], f.R[2], f.t[0], qx, qy, qz);
    ty = affine_row(f.R[3], f.R[4], f.R[5], f.t[1], qx, qy, qz);
    tz = affine_row(f.R[6], f.R[7], f.R[8], f.t[2], qx, qy, qz);
    ex = __fsub_rn(tx, f.ccx);
    ey = __fsub_rn(ty, f.ccy);
    ez = __fsub_rn(tz, f.ccz);
    qn = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                   __fmul_rn(ez, ez));
    dqc = sqrtf(qn);
  }
};

// Block-wide: the number of leading windows of this cell's row that any
// valid query can reach, 0 when the cell has no valid query. Lanes are
// sorted by |c|, so the window bounds bw[w] (least |c| of window w, +inf
// for a window of empty lanes) rise with w. A lane c of window w is at
// |e - c| >= |c| - |e| >= bw[w] - dqc from a query, so a window with
// bw[w] > rr + max dqc holds no lane within rr of any query of the cell,
// and neither does any later window. f32 addition is monotone, so
// rr + dqc <= rr + max dqc as rounded too: every per-query gate of the
// form `x + dqc < bw[w]` with x <= rr stops at or before the returned
// window. At least `min_windows` (capped at the real ones) are kept.
// Call from every thread of the block.
__device__ __forceinline__ int reach_windows(const float* qc, const int* qi,
                                             int qcap, const Frame& f,
                                             const float* bw, int NW,
                                             float rr, int min_windows) {
  __shared__ float s_reach;
  __shared__ int s_any;
  if (threadIdx.x == 0) {
    s_reach = 0.f;
    s_any = 0;
  }
  __syncthreads();
  float far = 0.f;
  int any = 0;
  for (int q = threadIdx.x; q < qcap; q += kThreads) {
    if (qi[q] < 0) continue;
    any = 1;
    far = fmaxf(far, Query(f, qc[q], qc[qcap + q], qc[2 * qcap + q]).dqc);
  }
  // non-negative floats order as their bit patterns
  if (any) {
    atomicMax(reinterpret_cast<int*>(&s_reach), __float_as_int(far));
    s_any = 1;
  }
  __syncthreads();
  if (!s_any) return 0;
  const float reach = rr + s_reach;
  const int real = __syncthreads_count(
      threadIdx.x < NW && bw[threadIdx.x] < __int_as_float(0x7f800000));
  const int in_reach =
      __syncthreads_count(threadIdx.x < NW && bw[threadIdx.x] <= reach);
  return max(in_reach, min(min_windows, real));
}

// Stages the first `n` lanes of row `cr` ([4, KC] planes) as one float4 a
// lane.
__device__ __forceinline__ void stage_row(float4* row, const float* cr,
                                          int KC, int n) {
  for (int k = threadIdx.x; k < n; k += kThreads)
    row[k] = make_float4(cr[k], cr[KC + k], cr[2 * KC + k], cr[3 * KC + k]);
}

}  // namespace rungrid
