// Run-grid truncated-Gaussian moments for Hopper (sm_90a), bound to Python
// with ctypes: the FilterReg E-step.
//
// Replaces the TPU kernel `_make_gmm_kernel` (cupoch_tpu/knn/rungrid.py:1141,
// launched by `gmm_moments`, :1230). The wrapper and the plain PyTorch
// version are in knn/rungrid_gmm.py; the shift to the world frame follows
// in PyTorch.
//
// What it computes, for every binned query q of cell c with qidx[c, q] >= 0
// (0 for the others):
//   e    = R q + t_pose - cc(c), qn = |e|^2
//   d2_k = (((cn_k + ex cx'_k) + ey cy'_k) + ez cz'_k) + qn
//   w_k  = d2_k <= r^2 ? exp(-max(d2_k, 0) * inv_2s2) : 0
//   m0 = sum w_k, m1 = sum (w_k * -0.5) c'_k (3), m2 = sum w_k cn_k
// over the KC lanes of row c, where c'_k = -0.5 (cx', cy', cz') is the
// candidate relative to cc. Windows are gated per query: lanes are sorted
// by |c|, and a window whose least |c| exceeds r + |e| holds no lane within
// r, nor does any later window, so the scan stops there. expf (not
// __expf) keeps the weights within 2 ulp of the plain version's.
//
// Layout: params [32] f32 (R 0-8, t 9-11, r^2 12, origin 13-15, cell 16,
// inv_2s2 17); qsoa [Cp, NQ, qcap] f32; qidx [Cp, qcap] i32; cand
// [Cp, 4, KC] f32; bounds [Cp, KC / 128] f32; out [5, Cp, qcap] f32.
//
// Bound: each cell holding a query must read the windows of its row within
// r + |e| of its farthest query (16 bytes a lane), with the query rows and
// the five outputs; arithmetic is about 15 f32 operations and one exp per
// (query, lane within the windows it reaches). Design: one block of 8
// warps per cell stages just those windows of the row in shared memory as
// one float4 a lane (rungrid_common.cuh); one warp per query, its lanes
// striding over the lanes of each window, then a shuffle sum.

#include <cuda_runtime.h>

#include "rungrid_common.cuh"

namespace {

using rungrid::Frame;
using rungrid::kThreads;
using rungrid::kWarps;
using rungrid::kWindow;
using rungrid::Query;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const float* __restrict__ params,
               const float* __restrict__ qsoa, const int* __restrict__ qidx,
               const float* __restrict__ cand,
               const float* __restrict__ bounds, float* __restrict__ out,
               int Cp, int NQ, int qcap, int KC, int Gx, int Gy, int Gz) {
  extern __shared__ float4 row[];                         // [KC]
  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int NW = KC / kWindow;
  const size_t plane = static_cast<size_t>(Cp) * qcap;
  float* o = out + static_cast<size_t>(cell) * qcap;
  const float* qc = qsoa + static_cast<size_t>(cell) * NQ * qcap;
  const int* qi = qidx + static_cast<size_t>(cell) * qcap;
  const float* bw = bounds + static_cast<size_t>(cell) * NW;
  const Frame f(params, cell, Gx, Gy, Gz);
  const float r2 = params[12], inv_2s2 = params[17];
  const float rr = sqrtf(r2);

  // the windows within r of some query of the cell (see reach_windows):
  // none when no query is valid or no lane is in reach, and then every
  // moment is 0
  const int nw = rungrid::reach_windows(qc, qi, qcap, f, bw, NW, rr, 0);
  if (nw == 0) {
    for (int q = tid; q < qcap; q += kThreads)
      for (int m = 0; m < 5; ++m) o[m * plane + q] = 0.f;
    return;
  }
  rungrid::stage_row(row, cand + static_cast<size_t>(cell) * 4 * KC, KC,
                     nw * kWindow);
  __syncthreads();

  for (int q = warp; q < qcap; q += kWarps) {
    if (qi[q] < 0) {
      if (lane == 0)
        for (int m = 0; m < 5; ++m) o[m * plane + q] = 0.f;
      continue;
    }
    const Query e(f, qc[q], qc[qcap + q], qc[2 * qcap + q]);
    float m0 = 0.f, m1x = 0.f, m1y = 0.f, m1z = 0.f, m2 = 0.f;
    for (int w = 0; w < nw; ++w) {
      if (rr + e.dqc < bw[w]) break;   // this and every later window
      for (int k = w * kWindow + lane; k < (w + 1) * kWindow; k += 32) {
        const float4 c = row[k];
        float d2 = __fadd_rn(c.w, __fmul_rn(e.ex, c.x));
        d2 = __fadd_rn(d2, __fmul_rn(e.ey, c.y));
        d2 = __fadd_rn(d2, __fmul_rn(e.ez, c.z));
        d2 = __fadd_rn(d2, e.qn);
        const float wk =
            d2 <= r2 ? expf(__fmul_rn(-fmaxf(d2, 0.f), inv_2s2)) : 0.f;
        const float eh = __fmul_rn(wk, -0.5f);
        m0 += wk;
        m1x += eh * c.x;
        m1y += eh * c.y;
        m1z += eh * c.z;
        m2 += wk * c.w;
      }
    }
    m0 = warp_sum(m0);
    m1x = warp_sum(m1x);
    m1y = warp_sum(m1y);
    m1z = warp_sum(m1z);
    m2 = warp_sum(m2);
    if (lane == 0) {
      o[q] = m0;
      o[plane + q] = m1x;
      o[2 * plane + q] = m1y;
      o[3 * plane + q] = m1z;
      o[4 * plane + q] = m2;
    }
  }
}

}  // namespace

// Launches the moments pass on `stream`; returns cudaGetLastError() (0 when
// the launch was accepted). All pointers are device pointers to contiguous
// tensors (see the layout above; cand 16-byte aligned).
extern "C" int rungrid_gmm_launch(const void* params, const void* qsoa,
                                  const void* qidx, const void* cand,
                                  const void* bounds, void* out, int Cp,
                                  int NQ, int qcap, int KC, int Gx, int Gy,
                                  int Gz, void* stream) {
  const size_t smem = static_cast<size_t>(KC) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_kernel<<<Cp, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(qsoa),
      static_cast<const int*>(qidx), static_cast<const float*>(cand),
      static_cast<const float*>(bounds), static_cast<float*>(out), Cp, NQ,
      qcap, KC, Gx, Gy, Gz);
  return static_cast<int>(cudaGetLastError());
}
