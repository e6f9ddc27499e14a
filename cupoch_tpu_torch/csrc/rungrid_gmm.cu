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
// candidate relative to cc. d2 is rounded operation by operation in that
// order (__fmul_rn/__fadd_rn), as the plain version rounds it, so both
// apply the r^2 cut to the same value. The weight is 2^(max(d2, 0) * s)
// with s = -inv_2s2 log2(e), one ex2.approx: its relative error (the
// rounding of the scaled argument, at most 6.5 in magnitude, and the
// approximation's own) stays under 1e-6, far inside the kernel's limits
// against the plain version (rtol 2e-5, atol 1e-5). m1 is summed as
// sum w_k c'_k and scaled by -0.5 at the end, which is exact.
//
// Windows are gated: lanes are sorted by |c|, and a window whose least |c|
// exceeds r + |e| holds no lane within r of that query, nor does any later
// window. Lanes scanned past a query's own gate lie beyond r in exact
// arithmetic and weigh 0, or at the f32 edge what the plain version (which
// has no gate) gives them.
//
// Layout: params [32] f32 (R 0-8, t 9-11, r^2 12, origin 13-15, cell 16,
// inv_2s2 17); qsoa [Cp, NQ, qcap] f32; qidx [Cp, qcap] i32; cand
// [Cp, 4, KC] f32; bounds [Cp, KC / 128] f32; out [5, Cp, qcap] f32.
//
// Bound: each cell holding a query must read the windows of its row within
// r + |e| of its farthest query (16 bytes a lane), with the query rows and
// the five outputs; the arithmetic, about 16 f32 operations and one exp
// per (query, lane within the windows it reaches), bounds it on this card
// (0.18 ms at the FilterReg plan of 1M points). What holds the kernel is
// instruction issue: 17 instructions a (query, lane) in the hot loop (7
// for d2, the cut, the clamp, the scale, the exp, zeroing the weight of a
// lane past r, 5 moment sums), so about 0.45 ms of issue at that plan.
//
// Design. The earlier design gave one warp to each query, so each float4
// read from shared memory served one (query, lane), every query ended in
// five 32-lane shuffle sums, and each block of 8 warps reserved KC x 16
// bytes of shared memory (48 KB at KC 3072) for its row. Here:
// - The cell's valid queries are sorted by |e|, ties by slot (so a warp's
//   queries reach about as far, and the last query of a warp or a pass
//   reaches farthest: the window counts below rely on it), and taken 16
//   at a time (a pass of the block's 2 warps):
//   8 a warp, as 4 groups of 8 threads with 2 queries each (1 each when a
//   warp has at most 4). A group's 8 threads stride over a window's 128
//   lanes, 4 adjacent lanes a read, and the 4 groups of a warp read the
//   same addresses (one broadcast serves its 8 queries); a query's sums
//   end in 3 shuffle steps within its group.
// - A warp scans window w while its farthest query reaches it; the block
//   streams the windows its farthest query of the pass reaches through a
//   ring of 4 window buffers (2 KB each), filled with cp.async three
//   windows ahead of the one being scored.
// - Small blocks: a window's barrier holds 2 warps, not 8, so a warp
//   whose queries finish early waits on one other warp, and 12 blocks of
//   80 registers a thread share an SM (8 KB of shared memory each).
// The sort, the grouping and the window ring are rungrid_common.cuh's,
// shared with the fused pass.

#include <cuda_runtime.h>

#include "rungrid_common.cuh"

namespace {

using rungrid::Frame;
using rungrid::kFull;
using rungrid::kGroup;
using rungrid::kPassQueries;
using rungrid::kThreads;
using rungrid::kWarpQueries;
using rungrid::kWindow;
using rungrid::kWindowFloats;
using rungrid::Query;

constexpr int kMinBlocks = 12;                  // an SM holds; caps registers
constexpr int kRing = 4;                        // window buffers
constexpr int kWarps = rungrid::kWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Queries a thread holds: cell-centred e, qn, and five running sums
// (m0, m1 x/y/z as sum w c', m2).
struct Held {
  float ex[2], ey[2], ez[2], qn[2];
  float m[2][5];
};

template <int Q>
__device__ __forceinline__ void visit(Held& h, float cx, float cy, float cz,
                                      float cn, float r2, float scale) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float d2 = __fadd_rn(cn, __fmul_rn(h.ex[j], cx));
    d2 = __fadd_rn(d2, __fmul_rn(h.ey[j], cy));
    d2 = __fadd_rn(d2, __fmul_rn(h.ez[j], cz));
    d2 = __fadd_rn(d2, h.qn[j]);
    const float wk = d2 <= r2 ? exp2_approx(fmaxf(d2, 0.f) * scale) : 0.f;
    h.m[j][0] += wk;
    h.m[j][1] = fmaf(wk, cx, h.m[j][1]);
    h.m[j][2] = fmaf(wk, cy, h.m[j][2]);
    h.m[j][3] = fmaf(wk, cz, h.m[j][3]);
    h.m[j][4] = fmaf(wk, cn, h.m[j][4]);
  }
}

// This thread's 16 lanes of one staged window (4 reads of 4 adjacent
// lanes), for its Q queries.
template <int Q>
__device__ __forceinline__ void scan_window(Held& h, const float* buf,
                                            int gl, float r2, float scale) {
#pragma unroll
  for (int c = 0; c < kWindow / (4 * kGroup); ++c) {
    const int base = (c * kGroup + gl) * 4;
    const float4 x = *reinterpret_cast<const float4*>(buf + base);
    const float4 y = *reinterpret_cast<const float4*>(buf + kWindow + base);
    const float4 z =
        *reinterpret_cast<const float4*>(buf + 2 * kWindow + base);
    const float4 n =
        *reinterpret_cast<const float4*>(buf + 3 * kWindow + base);
    visit<Q>(h, x.x, y.x, z.x, n.x, r2, scale);
    visit<Q>(h, x.y, y.y, z.y, n.y, r2, scale);
    visit<Q>(h, x.z, y.z, z.z, n.z, r2, scale);
    visit<Q>(h, x.w, y.w, z.w, n.w, r2, scale);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gmm_kernel(const float* __restrict__ params,
               const float* __restrict__ qsoa, const int* __restrict__ qidx,
               const float* __restrict__ cand,
               const float* __restrict__ bounds, float* __restrict__ out,
               int Cp, int NQ, int qcap, int KC, int Gx, int Gy, int Gz) {
  __shared__ __align__(16) float ring[kRing][kWindowFloats];
  extern __shared__ unsigned long long qs[];   // rungrid::sort_smem(qcap)
  __shared__ int s_n;

  const int cell = blockIdx.x;
  const int NW = KC / kWindow;
  const size_t plane = static_cast<size_t>(Cp) * qcap;
  float* o = out + static_cast<size_t>(cell) * qcap;
  const float* qc = qsoa + static_cast<size_t>(cell) * NQ * qcap;
  const int* qi = qidx + static_cast<size_t>(cell) * qcap;
  const float* bw = bounds + static_cast<size_t>(cell) * NW;
  const float* row = cand + static_cast<size_t>(cell) * 4 * KC;
  const Frame f(params, cell, Gx, Gy, Gz);
  const float r2 = params[12];
  const float rr = sqrtf(r2);
  const float scale = __fmul_rn(-params[17], kLog2e);

  // empty slots get 0; valid ones are sorted by |e|, then by slot
  int* slot_s;
  float* dq_s;
  const int n = rungrid::sort_queries(
      qs, &s_n, qc, qi, qcap, f, &slot_s, &dq_s, [&](int s) {
        for (int m = 0; m < 5; ++m) o[m * plane + s] = 0.f;
      });
  if (n == 0) return;          // uniform across the block

  for (int p0 = 0; p0 < n; p0 += kPassQueries) {
    // the windows the pass's farthest query reaches (all the block
    // streams), and those this warp's farthest query reaches
    const int np = min(kPassQueries, n - p0);
    const int nw = rungrid::windows_within(bw, NW, rr + dq_s[p0 + np - 1]);
    const rungrid::PassPlace pp(p0, n);
    const int gw = pp.cnt == 0 ? 0 : rungrid::windows_within(
        bw, NW, rr + dq_s[pp.w0 + pp.cnt - 1]);
    const bool pair = pp.pair;
    Held h;
    int slot[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      slot[j] = pp.idx[j] >= 0 ? slot_s[pp.idx[j]] : -1;
      // a missing query scores a copy of the warp's first, unwritten
      const int s = pp.pos[j] >= 0 ? slot_s[pp.pos[j]] : 0;
      const Query e(f, qc[s], qc[qcap + s], qc[2 * qcap + s]);
      h.ex[j] = e.ex;
      h.ey[j] = e.ey;
      h.ez[j] = e.ez;
      h.qn[j] = e.qn;
#pragma unroll
      for (int m = 0; m < 5; ++m) h.m[j][m] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < nw) rungrid::load_window(ring[s], row, KC, s);
      rungrid::cp_async_commit();
    }
    for (int w = 0; w < nw; ++w) {
      rungrid::cp_async_wait_ring<kRing>();
      __syncthreads();         // window w landed; window w - 1 is done
      const int ahead = w + kRing - 1;
      if (ahead < nw)
        rungrid::load_window(ring[ahead % kRing], row, KC, ahead);
      rungrid::cp_async_commit();
      if (w < gw) {
        if (pair)
          scan_window<2>(h, ring[w % kRing], pp.gl, r2, scale);
        else
          scan_window<1>(h, ring[w % kRing], pp.gl, r2, scale);
      }
    }
    __syncthreads();           // the ring is free for the next pass

#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int m = 0; m < 5; ++m) {
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1)
          h.m[j][m] += __shfl_xor_sync(kFull, h.m[j][m], off);
      }
      if (pp.gl == 0 && slot[j] >= 0) {
        const int s = slot[j];
        o[s] = h.m[j][0];
        o[plane + s] = -0.5f * h.m[j][1];
        o[2 * plane + s] = -0.5f * h.m[j][2];
        o[3 * plane + s] = -0.5f * h.m[j][3];
        o[4 * plane + s] = h.m[j][4];
      }
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
  gmm_kernel<<<Cp, kThreads, rungrid::sort_smem(qcap),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(qsoa),
      static_cast<const int*>(qidx), static_cast<const float*>(cand),
      static_cast<const float*>(bounds), static_cast<float*>(out), Cp, NQ,
      qcap, KC, Gx, Gy, Gz);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the moments kernel that one SM holds at once for this qcap
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA
// error; `warps` gets the warps a block.
extern "C" int rungrid_gmm_occupancy(int qcap, int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gmm_kernel, kThreads, rungrid::sort_smem(qcap));
  if (err != cudaSuccess) return -static_cast<int>(err);
  *warps = kWarps;
  return blocks;
}
