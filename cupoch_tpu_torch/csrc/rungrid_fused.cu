// Run-grid fused pass for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_make_fused_kernel` (cupoch_tpu/knn/rungrid.py:603,
// launched by `fused_query`, :806) in both its modes. The wrapper and the
// plain PyTorch version are in knn/rungrid_fused.py.
//
// What it computes, for every binned query q of cell c with qidx[c, q] >= 0:
//   t    = R q + t_pose   e = t - cc(c)   qn = |e|^2           cc: cell centre
//   v_k  = ((cn_k + ex cx'_k) + ey cy'_k) + ez cz'_k   (= |c_k|^2 - 2 e.c_k)
//   best = min_k v_k, fetched = max over the lanes with v_k == best of the
//          lane's word(s), per channel
//   d2   = best + qn, ok = d2 <= r^2
// over the KC lanes of row c (candidates relative to cc, sorted by |c|).
//  * corres mode: out0 = ok ? max(d2, 0) : inf, out1 = ok ? -index : 1,
//    where the fetched word is -index (negidx; the tie goes to the
//    smallest index).
//  * GN mode: the winner's 16-bit attribute fields are unpacked as
//    u * scale + lo (params[18..]) and the Gauss-Newton terms of
//    `_gn_terms` (PT2PT: 17 Kabsch statistics; PT2PL, SYM: 21 JTJ + 6 JTr
//    + count + err) are summed over the block into one [32] row per cell;
//    the wrapper sums the rows.
// The score path is rounded operation by operation (rungrid_common.cuh, and
// __fmul_rn/__fadd_rn below) in the plain version's order, so nvcc cannot
// contract it into FMAs and the two pick the same winners with the same
// d2, bit for bit. The TPU kernel kept the prefix winner on an exact tie
// across its gated blocks; here a tie takes the largest word over every
// lane, as the JAX mirror does.
//
// Gating: lanes are sorted by |c|, so bounds[w] (the least |c| of 128-lane
// window w) rises with w. For a lane c in window w, |e - c| >= |c| - |e| >=
// bounds[w] - dqc with dqc = |e|. After the 256-lane prefix, a window with
// sqrt(min(best + qn, r^2)) + dqc < bounds[w] holds no lane nearer than the
// current best (nor any lane within r when best + qn > r^2), and neither
// does any later window: the query stops scanning there. This gates per
// query, finer than the TPU's two gated blocks per tile, and gives the same
// minimum. Since min(best + qn, r^2) <= r^2, no query passes the gate at a
// window with bounds[w] > r + the cell's largest dqc, so the block stages
// no lane past it. Empty lanes score |c|^2 = BIG, never below a real lane,
// so leaving windows of empty lanes out of the prefix changes nothing.
//
// Layout: params [32] f32 (R 0-8, t 9-11, r^2 12, origin 13-15, cell 16,
// unpack pairs 18..); qsoa [Cp, NQ, qcap] f32 (x, y, z, then the source
// normal for SYM); qidx [Cp, qcap] i32; cand [Cp, 4, KC] f32; words: corres
// mode negidx [Cp, KC] f32, GN mode attrp [Cp, P, KC] i32; bounds [Cp, NW].
//
// Bound: each cell that holds a query must read the windows of its row
// that its queries need (cand 16 bytes a lane, plus 4 bytes a lane a word
// channel), with the query rows and the outputs. Arithmetic is 7 f32
// operations per (query, scanned lane). At the shapes of the port's paths
// (1M queries, KC 896-2560) the bytes bound it.
//
// Design: one block of 8 warps per cell. The block first finds the windows
// any of its queries can reach (the prefix, then those within r + the
// farthest query's |e|; windows of empty lanes never). A cell with no
// valid query or no real lane writes its empty outputs and reads no row.
// Otherwise the block stages those windows of the row in shared memory
// (cand as one float4 a lane, the word channels beside it: up to 112 KB at
// KC = 4096, P = 3) and gives one warp to each query; the warp's lanes
// stride over the candidate lanes keeping a running (score, words) and a
// shuffle reduction combines them. Not done yet: overlapping the row's
// load with scoring (cp.async or TMA).

#include <cuda_runtime.h>

#include <climits>

#include "rungrid_common.cuh"

namespace {

using rungrid::Frame;
using rungrid::kThreads;
using rungrid::kWarps;
using rungrid::kWindow;
using rungrid::Query;

constexpr int kPrefix = 2 * kWindow;
constexpr int kSums = 32;
constexpr int kMaxWords = 3;

constexpr int kEstNone = 0;
constexpr int kEstPt2Pt = 1;
constexpr int kEstPt2Pl = 2;
constexpr int kEstSym = 3;

// the running winner: least score, per channel the largest word among
// the lanes that share it
template <int F>
struct Best {
  float s;
  int w[F];
};

template <int F>
__device__ __forceinline__ void consider(Best<F>& b, float v, const int* w) {
  if (v < b.s) {
    b.s = v;
#pragma unroll
    for (int ch = 0; ch < F; ++ch) b.w[ch] = w[ch];
  } else if (v == b.s) {
#pragma unroll
    for (int ch = 0; ch < F; ++ch) b.w[ch] = max(b.w[ch], w[ch]);
  }
}

template <int F>
__device__ __forceinline__ void warp_reduce(Best<F>& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    int w[F];
#pragma unroll
    for (int ch = 0; ch < F; ++ch)
      w[ch] = __shfl_xor_sync(0xffffffffu, b.w[ch], o);
    consider<F>(b, __shfl_xor_sync(0xffffffffu, b.s, o), w);
  }
}

__device__ __forceinline__ float unpack16(const float* params, int word,
                                          int field) {
  const int u = (field & 1) ? ((word >> 16) & 0xFFFF) : (word & 0xFFFF);
  return static_cast<float>(u) * params[19 + 2 * field] +
         params[18 + 2 * field];
}

// adds the Gauss-Newton / Kabsch terms of one query (`_gn_terms`) to acc
template <int EST, int F>
__device__ __forceinline__ void add_terms(float* acc, const float* params,
                                          const int* word, float tx, float ty,
                                          float tz, float ex, float ey,
                                          float ez, float ccx, float ccy,
                                          float ccz, float sx, float sy,
                                          float sz, float d2c) {
  float f[2 * F];
#pragma unroll
  for (int k = 0; k < 2 * F; ++k) f[k] = unpack16(params, word[k / 2], k);
  if constexpr (EST == kEstPt2Pt) {
    const float px = f[0] + ccx, py = f[1] + ccy, pz = f[2] + ccz;
    const float t3[3] = {tx, ty, tz}, p3[3] = {px, py, pz};
    acc[0] += 1.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      acc[1 + i] += t3[i];
      acc[4 + i] += p3[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[7 + 3 * i + k] += t3[i] * p3[k];
    acc[16] += d2c;
  } else {
    float j[6], r;
    if constexpr (EST == kEstPt2Pl) {
      const float nx = f[0], ny = f[1], nz = f[2], dd = f[3];
      r = nx * ex + ny * ey + nz * ez - dd;
      j[0] = ty * nz - tz * ny;
      j[1] = tz * nx - tx * nz;
      j[2] = tx * ny - ty * nx;
      j[3] = nx;
      j[4] = ny;
      j[5] = nz;
    } else {
      const float pxc = f[0], pyc = f[1], pzc = f[2];
      const float px = pxc + ccx, py = pyc + ccy, pz = pzc + ccz;
      const float mx = f[3] + sx, my = f[4] + sy, mz = f[5] + sz;
      r = (ex - pxc) * mx + (ey - pyc) * my + (ez - pzc) * mz;
      const float ux = tx + px, uy = ty + py, uz = tz + pz;
      j[0] = uy * mz - uz * my;
      j[1] = uz * mx - ux * mz;
      j[2] = ux * my - uy * mx;
      j[3] = mx;
      j[4] = my;
      j[5] = mz;
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int k = i; k < 6; ++k) acc[s++] += j[i] * j[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += j[i] * r;
    acc[27] += 1.f;
    acc[28] += d2c;
  }
}

template <int EST, bool CORRES, int F>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const float* __restrict__ params,
                 const float* __restrict__ qsoa,
                 const int* __restrict__ qidx,
                 const float* __restrict__ cand,
                 const void* __restrict__ words_in,
                 const float* __restrict__ bounds, float* __restrict__ out0,
                 float* __restrict__ out1, int NQ, int qcap, int KC, int Gx,
                 int Gy, int Gz) {
  extern __shared__ float4 smem[];
  float4* row = smem;                                     // [KC]
  int* words = reinterpret_cast<int*>(smem + KC);         // [F, KC]
  __shared__ float red[kWarps][kSums];

  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int NW = KC / kWindow;
  const float* qc = qsoa + static_cast<size_t>(cell) * NQ * qcap;
  const int* qi = qidx + static_cast<size_t>(cell) * qcap;
  const float* bw = bounds + static_cast<size_t>(cell) * NW;
  const Frame f(params, cell, Gx, Gy, Gz);
  const float r2 = params[12];
  // the windows any query may scan: the 256-lane prefix and those the
  // gate below can reach (see reach_windows); none when no query is valid
  // or the row holds no real lane, and then no query finds a candidate
  const int nw = rungrid::reach_windows(qc, qi, qcap, f, bw, NW, sqrtf(r2),
                                        kPrefix / kWindow);
  if (nw == 0) {
    if constexpr (CORRES) {
      for (int q = tid; q < qcap; q += kThreads) {
        out0[static_cast<size_t>(cell) * qcap + q] = __int_as_float(0x7f800000);
        out1[static_cast<size_t>(cell) * qcap + q] = 1.f;
      }
    } else if (tid < kSums) {
      out0[static_cast<size_t>(cell) * kSums + tid] = 0.f;
    }
    return;
  }

  const int KL = nw * kWindow;
  rungrid::stage_row(row, cand + static_cast<size_t>(cell) * 4 * KC, KC, KL);
  if constexpr (CORRES) {
    const float* ni =
        static_cast<const float*>(words_in) + static_cast<size_t>(cell) * KC;
    // -index is exact in f32 below 2^24 points, so it compares as an int
    for (int k = tid; k < KL; k += kThreads)
      words[k] = static_cast<int>(ni[k]);
  } else {
    const int* a =
        static_cast<const int*>(words_in) + static_cast<size_t>(cell) * F * KC;
    for (int ch = 0; ch < F; ++ch)
      for (int k = tid; k < KL; k += kThreads)
        words[ch * KC + k] = a[ch * KC + k];
  }
  __syncthreads();

  const int L1 = min(kPrefix, KL);

  float acc[kSums];
#pragma unroll
  for (int s = 0; s < kSums; ++s) acc[s] = 0.f;

  for (int q = warp; q < qcap; q += kWarps) {
    if (qi[q] < 0) {
      if (CORRES && lane == 0) {
        out0[static_cast<size_t>(cell) * qcap + q] = __int_as_float(0x7f800000);
        out1[static_cast<size_t>(cell) * qcap + q] = 1.f;
      }
      continue;
    }
    const Query e(f, qc[q], qc[qcap + q], qc[2 * qcap + q]);

    Best<F> b;
    b.s = __int_as_float(0x7f800000);
#pragma unroll
    for (int ch = 0; ch < F; ++ch) b.w[ch] = INT_MIN;
    auto scan = [&](int lo, int hi) {
      for (int k = lo + lane; k < hi; k += 32) {
        const float4 c = row[k];
        float v = __fadd_rn(c.w, __fmul_rn(e.ex, c.x));
        v = __fadd_rn(v, __fmul_rn(e.ey, c.y));
        v = __fadd_rn(v, __fmul_rn(e.ez, c.z));
        int w[F];
#pragma unroll
        for (int ch = 0; ch < F; ++ch) w[ch] = words[ch * KC + k];
        consider<F>(b, v, w);
      }
      warp_reduce<F>(b);
    };
    scan(0, L1);
    for (int w = L1 / kWindow; w < nw; ++w) {
      const float bestd = sqrtf(fmaxf(fminf(b.s + e.qn, r2), 0.f));
      if (bestd + e.dqc < bw[w]) break;   // this and every later window
      scan(w * kWindow, (w + 1) * kWindow);
    }

    const float d2 = __fadd_rn(b.s, e.qn);
    const bool ok = d2 <= r2;
    if (lane != 0) continue;
    if constexpr (CORRES) {
      out0[static_cast<size_t>(cell) * qcap + q] =
          ok ? fmaxf(d2, 0.f) : __int_as_float(0x7f800000);
      out1[static_cast<size_t>(cell) * qcap + q] =
          ok ? static_cast<float>(b.w[0]) : 1.f;
    } else if (ok) {
      float sx = 0.f, sy = 0.f, sz = 0.f;
      if constexpr (EST == kEstSym) {
        const float s0 = qc[3 * qcap + q], s1 = qc[4 * qcap + q],
                    s2 = qc[5 * qcap + q];
        sx = f.R[0] * s0 + f.R[1] * s1 + f.R[2] * s2;
        sy = f.R[3] * s0 + f.R[4] * s1 + f.R[5] * s2;
        sz = f.R[6] * s0 + f.R[7] * s1 + f.R[8] * s2;
      }
      add_terms<EST, F>(acc, params, b.w, e.tx, e.ty, e.tz, e.ex, e.ey, e.ez,
                        f.ccx, f.ccy, f.ccz, sx, sy, sz, fmaxf(d2, 0.f));
    }
  }

  if constexpr (CORRES) return;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) red[warp][s] = acc[s];
  }
  __syncthreads();
  if (tid < kSums) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    out0[static_cast<size_t>(cell) * kSums + tid] = s;
  }
}

template <int EST, bool CORRES, int F>
int launch(const void* params, const void* qsoa, const void* qidx,
           const void* cand, const void* words, const void* bounds,
           void* out0, void* out1, int Cp, int NQ, int qcap, int KC, int Gx,
           int Gy, int Gz, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(KC) * sizeof(float4) +
                      static_cast<size_t>(F) * KC * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<EST, CORRES, F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<EST, CORRES, F><<<Cp, kThreads, smem, stream>>>(
      static_cast<const float*>(params), static_cast<const float*>(qsoa),
      static_cast<const int*>(qidx), static_cast<const float*>(cand), words,
      static_cast<const float*>(bounds), static_cast<float*>(out0),
      static_cast<float*>(out1), NQ, qcap, KC, Gx, Gy, Gz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the fused pass on `stream`; returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue (1) for a mode this
// file does not build. All pointers are device pointers to contiguous
// tensors (see the layout above; cand 16-byte aligned). corres != 0:
// `words` is negidx, out0/out1 are [Cp, qcap] d2 and -index. corres == 0:
// `words` is attrp with P channels, out0 is [Cp, 32] (out1 unused).
extern "C" int rungrid_fused_launch(const void* params, const void* qsoa,
                                    const void* qidx, const void* cand,
                                    const void* words, const void* bounds,
                                    void* out0, void* out1, int Cp, int NQ,
                                    int qcap, int KC, int P, int est,
                                    int corres, int Gx, int Gy, int Gz,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (corres)
    return launch<kEstNone, true, 1>(params, qsoa, qidx, cand, words, bounds,
                                     out0, out1, Cp, NQ, qcap, KC, Gx, Gy,
                                     Gz, s);
  if (est == kEstPt2Pt && P == 2)
    return launch<kEstPt2Pt, false, 2>(params, qsoa, qidx, cand, words,
                                       bounds, out0, out1, Cp, NQ, qcap, KC,
                                       Gx, Gy, Gz, s);
  if (est == kEstPt2Pl && P == 2)
    return launch<kEstPt2Pl, false, 2>(params, qsoa, qidx, cand, words,
                                       bounds, out0, out1, Cp, NQ, qcap, KC,
                                       Gx, Gy, Gz, s);
  if (est == kEstSym && P == kMaxWords)
    return launch<kEstSym, false, 3>(params, qsoa, qidx, cand, words, bounds,
                                     out0, out1, Cp, NQ, qcap, KC, Gx, Gy,
                                     Gz, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
