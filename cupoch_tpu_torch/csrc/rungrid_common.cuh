// Run-grid helpers shared by rungrid_fused.cu and rungrid_gmm.cu: the
// score path that makes both kernels agree bit for bit with their plain
// PyTorch versions, the cell's queries sorted by |e| and grouped, and the
// cp.async ring that streams a row's windows.
//
// Every multiply and add of the query transform and the cell centre is
// rounded on its own (__fmul_rn/__fadd_rn) in the plain version's order,
// so nvcc cannot contract them into FMAs.
//
// Both kernels run blocks of 2 warps, one block per cell. A cell's valid
// queries are sorted by |e| (so a warp's queries reach about as far, and
// the last query of a warp or a pass reaches farthest) and taken 16 at a
// time (a pass): 8 a warp, as 4 groups of 8 threads with 2 queries each
// (1 each when a warp holds at most 4). A group's 8 threads stride over a
// window's 128 lanes, 4 adjacent lanes a read, and the 4 groups of a warp
// read the same addresses, so one broadcast serves its 8 queries. The
// windows a pass scans stream through a ring of window buffers (2 KB
// each, the ring's size a kernel's own), filled with cp.async ahead of the
// window being scored.
#pragma once

#include <cuda_runtime.h>

namespace rungrid {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 128;
constexpr int kGroup = 8;                        // threads of one query group
constexpr int kWarpQueries = 2 * 32 / kGroup;    // 8: 4 groups x 2
constexpr int kPassQueries = kWarps * kWarpQueries;
constexpr int kWindowFloats = 4 * kWindow;       // x', y', z', |c|^2 planes
constexpr unsigned kFull = 0xffffffffu;

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

  Frame() = default;     // so that a block can keep one in shared memory
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

// Shared memory for the sort: qcap keys, then the sorted slots and |e|.
__host__ __device__ inline size_t sort_smem(int qcap) {
  return static_cast<size_t>(qcap) * (sizeof(unsigned long long) +
                                      sizeof(int) + sizeof(float));
}

// Block-wide: lists the cell's valid queries (qidx >= 0) with a key that
// orders them by |e| and then by slot: the bits of |e| (>= 0, so they
// order as the floats do) above the slot. Keys are unique, so the order
// is the same on every run and exact in |e|. Writes the sorted slots to
// slot_s and their |e| to dq_s (in `qs`, laid out as sort_smem says) and
// returns how many there are; `on_empty(s)` runs for every invalid slot.
template <typename OnEmpty>
__device__ __forceinline__ int sort_queries(unsigned long long* qs,
                                            int* s_n, const float* qc,
                                            const int* qi, int qcap,
                                            const Frame& f, int** slot_out,
                                            float** dq_out,
                                            OnEmpty on_empty) {
  unsigned long long* key = qs;                           // valid, unsorted
  int* slot_s = reinterpret_cast<int*>(qs + qcap);        // sorted slots
  float* dq_s = reinterpret_cast<float*>(slot_s + qcap);  // sorted |e|
  *slot_out = slot_s;
  *dq_out = dq_s;
  const int tid = threadIdx.x;
  if (tid == 0) *s_n = 0;
  __syncthreads();
  for (int s = tid; s < qcap; s += kThreads) {
    if (qi[s] < 0) {
      on_empty(s);
      continue;
    }
    const float d = Query(f, qc[s], qc[qcap + s], qc[2 * qcap + s]).dqc;
    key[atomicAdd(s_n, 1)] =
        static_cast<unsigned long long>(__float_as_uint(d)) << 32 |
        static_cast<unsigned>(s);
  }
  __syncthreads();
  const int n = *s_n;
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long k = key[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += key[j] < k;
    slot_s[r] = static_cast<int>(k & 0xffffffffu);
    dq_s[r] = __uint_as_float(static_cast<unsigned>(k >> 32));
  }
  __syncthreads();
  return n;
}

// The leading windows of a row whose least |c| is within `reach` (the
// window bounds rise with w); call from a whole warp, NW <= 32.
__device__ __forceinline__ int windows_within(const float* bw, int NW,
                                              float reach) {
  const int lane = threadIdx.x & 31;
  return __popc(__ballot_sync(kFull, lane < NW && bw[lane] <= reach));
}

// This thread's place in a pass that starts at sorted query p0 of n: the
// warp's first query and count, whether its groups hold 2 queries each,
// the thread's group and its place in it, and the sorted positions of its
// group's queries (-1: none). A missing query takes the warp's first
// query's position in `pos` (scored, never written).
struct PassPlace {
  int w0, cnt, g, gl;
  bool pair;
  int idx[2];    // sorted positions of the group's queries, -1 for none
  int pos[2];    // the position to score (a copy for a missing query)

  __device__ __forceinline__ PassPlace(int p0, int n) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    w0 = p0 + warp * kWarpQueries;
    cnt = max(0, min(kWarpQueries, n - w0));
    pair = cnt > kWarpQueries / 2;
    g = lane / kGroup;
    gl = lane % kGroup;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = g + j * (kWarpQueries / 2);
      idx[j] = t < cnt && (j == 0 || pair) ? w0 + t : -1;
      pos[j] = idx[j] >= 0 ? idx[j] : (cnt == 0 ? -1 : w0);
    }
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// in a ring of Ring window buffers: every group but the newest Ring - 2
// has landed
template <int Ring>
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Ring - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of window w of a row ([4, KC] planes) into `buf`: 128
// pieces of 16 bytes over the block's threads.
__device__ __forceinline__ void load_window(float* buf, const float* row,
                                            int KC, int w) {
  for (int t = threadIdx.x; t < kWindowFloats / 4; t += kThreads) {
    const int plane = t / (kWindow / 4), piece = t % (kWindow / 4);
    cp_async16(buf + plane * kWindow + piece * 4,
               row + static_cast<size_t>(plane) * KC + w * kWindow +
                   piece * 4);
  }
}

}  // namespace rungrid
