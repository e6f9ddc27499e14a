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
// lane scanned, as the JAX mirror does over every lane.
//
// Gating: lanes are sorted by |c|, so bounds[w] (the least |c| of 128-lane
// window w) rises with w. For a lane c in window w, |e - c| >= |c| - |e| >=
// bounds[w] - dqc with dqc = |e|. After the first window, a window with
// sqrt(min(best + qn, r^2)) + dqc < bounds[w] holds no lane nearer than the
// query's current best (nor any lane within r when best + qn > r^2), and
// neither does any later window: the query's gate closes there. A warp
// scans a window while the gate of any of its queries is open, so each
// query scans at least the windows its own gate opens, and lanes past its
// gate cannot be strictly nearer in exact arithmetic; the plain version
// scans every lane. (The TPU kernel scanned a 256-lane prefix before any
// gate; the gate is exact from the first window on, so one suffices.)
// Empty lanes score |c|^2 = BIG, never below a real lane, so leaving
// windows of empty lanes out changes nothing.
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
// (1M queries, KC 896-2560) the bytes bound it. The instructions a (query,
// lane) visit in the hot loop are 12: 6 for the score, and the strict `<`,
// the tie flag and two selects that keep (least score, its lane), with a
// share of the shared-memory reads.
//
// Design. The earlier design gave one warp of a block of 8 to each query,
// staged every reachable window of the row before scoring, carried the
// words and the tie rule through every visit, and ended each 128-lane
// window in a 32-lane reduction of (score, words); its GN terms ran on one
// lane. Here:
// - The cell's valid queries are sorted by |e| and taken 16 a pass, 8 a
//   warp, as 4 groups of 8 threads with 2 queries each (rungrid_common.cuh,
//   as the moments pass does): one broadcast read serves 8 queries, and a
//   query's minimum ends in 3 shuffle steps within its group.
// - The windows stream through a cp.async ring of 2 (the next one in
//   flight). After the first window a warp goes on while the gate of any
//   of its queries is open: its reach, the largest sqrt(min(best + qn,
//   r^2)) + |e| over its queries (3 shuffle steps a query and a `redux`),
//   must cover the window's bound. The block starts a window's copy only
//   while either warp's reach covers it, so a row is read about as far as
//   its queries need, not as far as the static reach r + |e|. On an H100
//   a ring of 2 beat rings of 3 and 4: a deeper ring starts copies the
//   gate then leaves unread.
// - The hot loop keeps (score, lane) with a strict `<` and a flag for an
//   exact tie. The winner's words are read once, after the scan, from
//   device memory; only for a query that saw a tie does one thread rescore
//   the lanes its warp scanned and take each channel's largest word among
//   those that tie.
// - GN mode: the thread of each group that holds a query computes its
//   terms and adds them to that query slot's row of sums in shared memory;
//   the block adds the 16 rows into its [32] row at the end.
// - Blocks of 2 warps (16 an SM in corres mode, 12 in GN mode, which
//   holds more state): a window's barrier holds 2 warps, and a cell of 13
//   queries (the evaluate plan) keeps both busy. The pose and the cell's
//   centre sit in shared memory, not in 15 registers a thread.

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

// blocks an SM holds (caps registers): GN mode carries more state
constexpr int kMinBlocksCorres = 16;
constexpr int kMinBlocksGN = 12;
constexpr int kWarps = rungrid::kWarps;
constexpr int kPrefixWindows = 1;      // scanned before any gate
constexpr int kRing = 2;               // window buffers
constexpr int kSums = 32;
constexpr int kMaxWords = 3;

constexpr int kEstNone = 0;
constexpr int kEstPt2Pt = 1;
constexpr int kEstPt2Pl = 2;
constexpr int kEstSym = 3;

// A query's running winner in one thread: the least score, its lane, and
// whether another lane scored exactly the same.
struct Win {
  float v;
  int k;
  bool tie;
};

// Queries a thread holds: cell-centred e and the running winners.
struct Held {
  float ex[2], ey[2], ez[2];
  Win w[2];
};

__device__ __forceinline__ float score(float ex, float ey, float ez, float cx,
                                       float cy, float cz, float cn) {
  float v = __fadd_rn(cn, __fmul_rn(ex, cx));
  v = __fadd_rn(v, __fmul_rn(ey, cy));
  return __fadd_rn(v, __fmul_rn(ez, cz));
}

template <int Q>
__device__ __forceinline__ void visit(Held& h, float cx, float cy, float cz,
                                      float cn, int k) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const float v = score(h.ex[j], h.ey[j], h.ez[j], cx, cy, cz, cn);
    Win& w = h.w[j];
    const bool lt = v < w.v;
    w.tie = lt ? false : (w.tie || v == w.v);
    w.k = lt ? k : w.k;
    w.v = lt ? v : w.v;
  }
}

// This thread's 16 lanes of one streamed window (4 reads of 4 adjacent
// lanes), for its Q queries; `k0` is the window's first lane.
template <int Q>
__device__ __forceinline__ void scan_window(Held& h, const float* buf,
                                            int gl, int k0) {
#pragma unroll
  for (int c = 0; c < kWindow / (4 * kGroup); ++c) {
    const int base = (c * kGroup + gl) * 4;
    const float4 x = *reinterpret_cast<const float4*>(buf + base);
    const float4 y = *reinterpret_cast<const float4*>(buf + kWindow + base);
    const float4 z =
        *reinterpret_cast<const float4*>(buf + 2 * kWindow + base);
    const float4 n =
        *reinterpret_cast<const float4*>(buf + 3 * kWindow + base);
    const int k = k0 + base;
    visit<Q>(h, x.x, y.x, z.x, n.x, k);
    visit<Q>(h, x.y, y.y, z.y, n.y, k + 1);
    visit<Q>(h, x.z, y.z, z.z, n.z, k + 2);
    visit<Q>(h, x.w, y.w, z.w, n.w, k + 3);
  }
}

// the least score within a query's group of 8 threads
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the group's winner, the same in all 8 threads: the least score; a tie
// when two threads hold it or one saw it twice
__device__ __forceinline__ void group_reduce(Win& w) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(kFull, w.v, o);
    const int k = __shfl_xor_sync(kFull, w.k, o);
    const bool tie = __shfl_xor_sync(kFull, static_cast<int>(w.tie), o);
    if (v < w.v) {
      w.v = v;
      w.k = k;
      w.tie = tie;
    } else if (v == w.v) {
      w.k = min(w.k, k);
      w.tie = true;
    }
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

// The fetched words of query (ex, ey, ez) whose least score v was tied:
// per channel, the largest word among the first `lanes` lanes of the row
// that score exactly v (rescored from device memory in the same order).
template <int F, typename Word>
__device__ __forceinline__ void tied_words(Word* out, const float* row,
                                           const Word* words, int KC,
                                           int lanes, float ex, float ey,
                                           float ez, float v) {
  for (int k = 0; k < lanes; ++k) {
    if (score(ex, ey, ez, row[k], row[KC + k], row[2 * KC + k],
              row[3 * KC + k]) != v)
      continue;
#pragma unroll
    for (int ch = 0; ch < F; ++ch) out[ch] = max(out[ch], words[ch * KC + k]);
  }
}

template <int EST, bool CORRES, int F>
__global__ void __launch_bounds__(kThreads,
                                  CORRES ? kMinBlocksCorres : kMinBlocksGN)
    fused_kernel(const float* __restrict__ params,
                 const float* __restrict__ qsoa,
                 const int* __restrict__ qidx,
                 const float* __restrict__ cand,
                 const void* __restrict__ words_in,
                 const float* __restrict__ bounds, float* __restrict__ out0,
                 float* __restrict__ out1, int NQ, int qcap, int KC, int Gx,
                 int Gy, int Gz) {
  __shared__ __align__(16) float ring[kRing][kWindowFloats];
  __shared__ float bw_s[32];
  __shared__ float reach_s[2][kWarps];   // each warp's reach, by w parity
  // GN mode: the running sums of each query slot of a pass (one row a
  // group thread that holds a query; padded against bank conflicts)
  __shared__ float acc_s[CORRES ? 1 : kPassQueries][kSums + 1];
  extern __shared__ unsigned long long qs[];   // rungrid::sort_smem(qcap)
  __shared__ int s_n;
  __shared__ Frame fs;     // the pose and the cell's centre

  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int NW = KC / kWindow;
  const float inf = __int_as_float(0x7f800000);
  const size_t orow = static_cast<size_t>(cell) * qcap;
  const float* qc = qsoa + static_cast<size_t>(cell) * NQ * qcap;
  const int* qi = qidx + static_cast<size_t>(cell) * qcap;
  const float* row = cand + static_cast<size_t>(cell) * 4 * KC;
  const float r2 = params[12];
  const float rr = sqrtf(r2);

  if (tid < 32) bw_s[tid] = tid < NW ? bounds[cell * NW + tid] : inf;
  if constexpr (!CORRES) {
    for (int i = tid; i < kPassQueries * (kSums + 1); i += kThreads)
      (&acc_s[0][0])[i] = 0.f;
  }
  if (tid == 0) fs = Frame(params, cell, Gx, Gy, Gz);
  __syncthreads();
  const Frame& f = fs;
  // empty slots find nothing; valid ones are sorted by |e|, then by slot
  int* slot_s;
  float* dq_s;
  const int n = rungrid::sort_queries(
      qs, &s_n, qc, qi, qcap, f, &slot_s, &dq_s, [&](int s) {
        if constexpr (CORRES) {
          out0[orow + s] = inf;
          out1[orow + s] = 1.f;
        }
      });
  // the windows that hold a real lane (the others have bound +inf)
  const int real = rungrid::windows_within(bw_s, NW, 3.4e38f);
  if (n == 0 || real == 0) {
    // no valid query, or no candidate for any
    if constexpr (CORRES) {
      for (int i = tid; i < n; i += kThreads) {
        out0[orow + slot_s[i]] = inf;
        out1[orow + slot_s[i]] = 1.f;
      }
    } else if (tid < kSums) {
      out0[static_cast<size_t>(cell) * kSums + tid] = 0.f;
    }
    return;
  }
  const int prefix = min(kPrefixWindows, real);

  for (int p0 = 0; p0 < n; p0 += kPassQueries) {
    // the windows the pass's farthest query can reach (the most the block
    // streams) and those this warp's farthest query can reach; the gate
    // closes at or before them, since its distance is at most r
    const int np = min(kPassQueries, n - p0);
    const int nw = max(
        rungrid::windows_within(bw_s, NW, rr + dq_s[p0 + np - 1]), prefix);
    const rungrid::PassPlace pp(p0, n);
    const int gw = pp.cnt == 0 ? 0 : max(rungrid::windows_within(
        bw_s, NW, rr + dq_s[pp.w0 + pp.cnt - 1]), prefix);
    Held h;
    float qn[2], dqc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // a missing query scores a copy of the warp's first, unwritten
      const int s = pp.pos[j] >= 0 ? slot_s[pp.pos[j]] : 0;
      const Query e(f, qc[s], qc[qcap + s], qc[2 * qcap + s]);
      h.ex[j] = e.ex;
      h.ey[j] = e.ey;
      h.ez[j] = e.ez;
      qn[j] = e.qn;
      dqc[j] = e.dqc;
      h.w[j] = Win{inf, 0, false};
    }
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
      if (s < nw) rungrid::load_window(ring[s], row, KC, s);
      rungrid::cp_async_commit();
    }
    int scanned = 0;                 // windows this warp has scanned
    // whether this warp needs window w, and how far its queries may still
    // need to look: the largest sqrt(min(best + qn, r^2)) + |e| over its
    // queries (at first r + |e|), which only shrinks as bests improve
    bool need = gw > 0;
    float reach = pp.cnt == 0 ? 0.f : rr + dq_s[pp.w0 + pp.cnt - 1];
    for (int w = 0;; ++w) {
      if ((threadIdx.x & 31) == 0) reach_s[w & 1][warp] = need ? reach : 0.f;
      rungrid::cp_async_wait_ring<kRing>();
      // window w landed; window w - 1 is done
      if (!__syncthreads_or(need)) break;
      // a window past the prefix is loaded only while some query of the
      // block may still need it (the bounds rise with w, the reach falls)
      const int ahead = w + kRing - 1;
      if (ahead < nw &&
          (ahead < prefix ||
           bw_s[ahead] <= fmaxf(reach_s[w & 1][0], reach_s[w & 1][1])))
        rungrid::load_window(ring[ahead % kRing], row, KC, ahead);
      rungrid::cp_async_commit();
      if (!need) continue;
      if (pp.pair)
        scan_window<2>(h, ring[w % kRing], pp.gl, w * kWindow);
      else
        scan_window<1>(h, ring[w % kRing], pp.gl, w * kWindow);
      scanned = w + 1;
      // the gate: the warp goes on while any of its queries may hold a
      // nearer lane in the next window
      reach = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float b = group_min(h.w[j].v);
        const float bestd = sqrtf(fmaxf(fminf(b + qn[j], r2), 0.f));
        if (pp.idx[j] >= 0) reach = fmaxf(reach, bestd + dqc[j]);
      }
      reach = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(reach)));
      need = w + 1 < gw && (w + 1 < prefix || !(reach < bw_s[w + 1]));
    }
    rungrid::cp_async_wait_all();
    __syncthreads();                 // the ring is free for the next pass

#pragma unroll
    for (int j = 0; j < 2; ++j) group_reduce(h.w[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // thread j of the group writes its query j
      if (pp.gl != j || pp.idx[j] < 0) continue;
      const int s = slot_s[pp.idx[j]];
      const Win& w = h.w[j];
      const float d2 = __fadd_rn(w.v, qn[j]);
      const bool ok = d2 <= r2;
      if constexpr (CORRES) {
        float word = 1.f;
        if (ok) {
          const float* ni = static_cast<const float*>(words_in) +
                            static_cast<size_t>(cell) * KC;
          word = ni[w.k];
          if (w.tie)
            tied_words<1>(&word, row, ni, KC, scanned * kWindow, h.ex[j],
                          h.ey[j], h.ez[j], w.v);
        }
        out0[orow + s] = ok ? fmaxf(d2, 0.f) : inf;
        out1[orow + s] = word;
      } else if (ok) {
        const int* a = static_cast<const int*>(words_in) +
                       static_cast<size_t>(cell) * F * KC;
        int word[F];
#pragma unroll
        for (int ch = 0; ch < F; ++ch) word[ch] = a[ch * KC + w.k];
        if (w.tie)
          tied_words<F>(word, row, a, KC, scanned * kWindow, h.ex[j],
                        h.ey[j], h.ez[j], w.v);
        const Query e(f, qc[s], qc[qcap + s], qc[2 * qcap + s]);
        float sx = 0.f, sy = 0.f, sz = 0.f;
        if constexpr (EST == kEstSym) {
          const float s0 = qc[3 * qcap + s], s1 = qc[4 * qcap + s],
                      s2 = qc[5 * qcap + s];
          sx = f.R[0] * s0 + f.R[1] * s1 + f.R[2] * s2;
          sy = f.R[3] * s0 + f.R[4] * s1 + f.R[5] * s2;
          sz = f.R[6] * s0 + f.R[7] * s1 + f.R[8] * s2;
        }
        add_terms<EST, F>(acc_s[warp * kWarpQueries + pp.g +
                                j * (kWarpQueries / 2)],
                          params, word, e.tx, e.ty, e.tz, e.ex, e.ey, e.ez,
                          f.ccx, f.ccy, f.ccz, sx, sy, sz, fmaxf(d2, 0.f));
      }
    }
  }

  if constexpr (!CORRES) {
    __syncthreads();
    if (tid < kSums) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kPassQueries; ++q) s += acc_s[q][tid];
      out0[static_cast<size_t>(cell) * kSums + tid] = s;
    }
  }
}

template <int EST, bool CORRES, int F>
int launch(const void* params, const void* qsoa, const void* qidx,
           const void* cand, const void* words, const void* bounds,
           void* out0, void* out1, int Cp, int NQ, int qcap, int KC, int Gx,
           int Gy, int Gz, cudaStream_t stream) {
  fused_kernel<EST, CORRES, F>
      <<<Cp, kThreads, rungrid::sort_smem(qcap), stream>>>(
          static_cast<const float*>(params), static_cast<const float*>(qsoa),
          static_cast<const int*>(qidx), static_cast<const float*>(cand),
          words, static_cast<const float*>(bounds),
          static_cast<float*>(out0), static_cast<float*>(out1), NQ, qcap, KC,
          Gx, Gy, Gz);
  return static_cast<int>(cudaGetLastError());
}

template <int EST, bool CORRES, int F>
int occupancy(int qcap) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_kernel<EST, CORRES, F>, kThreads,
      rungrid::sort_smem(qcap));
  return err != cudaSuccess ? -static_cast<int>(err) : blocks;
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

// Blocks of the fused kernel for this mode that one SM holds at once at
// this qcap (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// CUDA error; `warps` gets the warps a block.
extern "C" int rungrid_fused_occupancy(int qcap, int P, int est, int corres,
                                       int* warps) {
  *warps = kWarps;
  if (corres) return occupancy<kEstNone, true, 1>(qcap);
  if (est == kEstPt2Pt && P == 2) return occupancy<kEstPt2Pt, false, 2>(qcap);
  if (est == kEstPt2Pl && P == 2) return occupancy<kEstPt2Pl, false, 2>(qcap);
  if (est == kEstSym && P == kMaxWords)
    return occupancy<kEstSym, false, 3>(qcap);
  return -static_cast<int>(cudaErrorInvalidValue);
}
