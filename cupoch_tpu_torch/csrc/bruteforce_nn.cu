// Exact brute-force 1-NN for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package's `knn/bruteforce.nn_search` is
// plain XLA, one matrix product a query tile on the MXU. The port's first
// version did the same in four PyTorch ops a tile (the product, a scale, a
// broadcast subtract and an argmin over a [tile, N] matrix); at KinFu's
// level 1, a 76.8k-point cloud padded to 131 072 on each side, that wrote
// and read a 17.2 G-float matrix four times an ICP iteration (~0.41 TB,
// ~120 ms at 3.35 TB/s) and held about 80% of the card's busy time in the
// benchmark's `kinfu640.handheld` cell. This kernel keeps no matrix in
// device memory and scores only the valid prefixes of the two clouds.
//
// What it computes, for each query q < nq (the wrapper is
// knn/bruteforce.nn_search; `nn_search_plain` is the plain version):
//   d2_i = (dx dx + dy dy) + dz dz,  d = q - p_i,  over the points i < nd
//          whose mask is set,
//   out  = (the least i among the least d2_i, that d2), or (-1, +inf) when
//          no point scores below +inf (none unmasked, or every d2 inf or
//          NaN); queries nq .. Q-1 get (-1, +inf).
// Every operation is rounded on its own (__fsub_rn / __fmul_rn /
// __fadd_rn), in the plain version's order, so the two agree bit for bit.
//
// Bound: 8 f32 operations a (query, point) pair and no memory traffic
// beyond the two clouds. At level 1, 76.8k x 76.8k = 5.90 G pairs, that is
// 47.2 G operations, 0.70 ms at 67 TFLOP/s; but the operations cannot fuse
// into FMAs (67 TFLOP/s counts an FMA as two), so the FP32 pipes issue them
// at half that rate, 1.41 ms, and the strict `<` and the two selects that
// keep (d2, index) make 11 instructions a pair: an issue ceiling of
// 1.94 ms on 132 SMs at 1980 MHz.
//
// Design. Each thread holds kQPT = 8 queries in registers, so one
// shared-memory read (a float4 broadcast to the warp) serves 8 pairs and
// the hot loop is the 11 instructions a pair. A prologue kernel stages the
// points once as float4 (x, y, z, 0), masked and padding points at +inf (a
// finite query then scores +inf there, which never passes the strict `<`
// from +inf); blocks stream them through shared memory in tiles of kTile,
// in ascending index order, double-buffered with cp.async, so a strict `<`
// keeps the least index of a tie within a thread's scan. A second grid
// dimension splits the points, so that the card is full at 19k queries
// as at 77k: the number of splits follows from the SMs, the blocks an SM
// holds and the number of query blocks, so that the launch is one wave.
// The splits meet in a 64-bit atomicMin on the key (bits(d2) << 32) |
// index: non-negative floats order as their bits, so the least key is the
// least d2 and then the least index, whatever order the blocks run in. An
// epilogue kernel unpacks the keys.

#include <cuda_runtime.h>

#include "rungrid_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQPT = 8;                      // queries a thread
constexpr int kQB = kThreads * kQPT;         // queries a block
constexpr int kTile = 256;                   // points a staged tile
constexpr unsigned long long kNone = ~0ull;  // key of "no point"

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

size_t keys_bytes(int Q) {
  return (static_cast<size_t>(Q) * sizeof(unsigned long long) + 15) & ~15ull;
}

int tiles_of(int nd) { return (nd + kTile - 1) / kTile; }

// pts[i] = (x, y, z, 0) of point i, or +inf where i >= nd or masked out,
// for i < n_pts; keys[i] = kNone for i < Q.
__global__ void stage_kernel(const float* __restrict__ data,
                             const unsigned char* __restrict__ mask,
                             float4* __restrict__ pts,
                             unsigned long long* __restrict__ keys, int nd,
                             int n_pts, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_pts) {
    const float inf = inf_f();
    float4 p = make_float4(inf, inf, inf, 0.0f);
    if (i < nd && (mask == nullptr || mask[i])) {
      const float* d = data + 3 * static_cast<size_t>(i);
      p = make_float4(d[0], d[1], d[2], 0.0f);
    }
    pts[i] = p;
  }
  if (i < Q) keys[i] = kNone;
}

// Block (bx, s): queries bx * kQB .. + kQB against the tiles
// s * tiles_per_split .. + tiles_per_split (the last split may hold fewer).
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ queries,
              const float4* __restrict__ pts,
              unsigned long long* __restrict__ keys, int nq, int n_tiles,
              int tiles_per_split) {
  __shared__ __align__(16) float4 buf[2][kTile];
  const int t0 = blockIdx.y * tiles_per_split;
  const int nt = min(tiles_per_split, n_tiles - t0);

  float qx[kQPT], qy[kQPT], qz[kQPT], bd[kQPT];
  int bi[kQPT];
  const int q0 = blockIdx.x * kQB + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int q = q0 + j * kThreads;
    qx[j] = qy[j] = qz[j] = 0.0f;
    if (q < nq) {
      const float* p = queries + 3 * static_cast<size_t>(q);
      qx[j] = p[0];
      qy[j] = p[1];
      qz[j] = p[2];
    }
    bd[j] = inf_f();
    bi[j] = -1;
  }

  auto load = [&](int t) {
    const float* src = reinterpret_cast<const float*>(
        pts + static_cast<size_t>(t0 + t) * kTile);
    float* dst = reinterpret_cast<float*>(buf[t & 1]);
    for (int k = threadIdx.x; k < kTile; k += kThreads)
      rungrid::cp_async16(dst + 4 * k, src + 4 * k);
    rungrid::cp_async_commit();
  };
  load(0);
  for (int t = 0; t < nt; ++t) {
    rungrid::cp_async_wait_all();   // this thread's copies of tile t landed
    __syncthreads();                // everyone's; and tile t - 1 is done
    if (t + 1 < nt) load(t + 1);    // into tile t - 1's buffer
    const float4* tile = buf[t & 1];
    const int base = (t0 + t) * kTile;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float4 p = tile[k];
      const int i = base + k;
#pragma unroll
      for (int j = 0; j < kQPT; ++j) {
        const float dx = __fsub_rn(qx[j], p.x);
        const float dy = __fsub_rn(qy[j], p.y);
        const float dz = __fsub_rn(qz[j], p.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < bd[j]) {       // ascending i: keeps the least index
          bd[j] = d2;
          bi[j] = i;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kQPT; ++j) {
    const int q = q0 + j * kThreads;
    if (q < nq && bi[j] >= 0)
      atomicMin(&keys[q],
                (static_cast<unsigned long long>(__float_as_uint(bd[j]))
                 << 32) |
                    static_cast<unsigned>(bi[j]));
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              int* __restrict__ idx, float* __restrict__ d2,
                              int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const unsigned long long k = keys[i];
  idx[i] = k == kNone ? -1 : static_cast<int>(k & 0xffffffffu);
  d2[i] = k == kNone ? inf_f() : __uint_as_float(static_cast<unsigned>(k >> 32));
}

// The splits of the point tiles for nq queries on nd points, so that the
// launch is about one wave of resident blocks; 0 when there is no work, a
// negative CUDA error on failure.
int plan_splits(int nq, int nd) {
  const int n_tiles = tiles_of(nd);
  if (nq <= 0 || n_tiles == 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const long long qblocks = (nq + kQB - 1) / kQB;
  long long splits = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) /
                     qblocks;
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  return (n_tiles + per_split - 1) / per_split;
}

}  // namespace

// Bytes of scratch `bruteforce_nn_launch` needs for Q queries on nd points.
extern "C" long long bruteforce_nn_scratch_bytes(int Q, int nd) {
  return static_cast<long long>(keys_bytes(Q)) +
         static_cast<long long>(tiles_of(nd)) * kTile * sizeof(float4);
}

// Launches the staging, search and unpacking kernels on `stream`; returns
// cudaGetLastError() (0 when every launch was accepted). Device pointers to
// contiguous tensors: queries [Q, 3] f32, data [>= nd, 3] f32, mask
// [>= nd] bool or null, scratch of bruteforce_nn_scratch_bytes(Q, nd)
// bytes (16-byte aligned), idx [Q] int32, d2 [Q] f32. Only queries < nq
// and points < nd are scored.
extern "C" int bruteforce_nn_launch(const void* queries, const void* data,
                                    const void* mask, void* scratch,
                                    void* idx, void* d2, int Q, int nq,
                                    int nd, void* stream) {
  if (Q == 0) return 0;
  if (reinterpret_cast<size_t>(scratch) % 16 != 0 || nq > Q || nq < 0 ||
      nd < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = plan_splits(nq, nd);
  if (splits < 0) return -splits;
  auto* keys = static_cast<unsigned long long*>(scratch);
  auto* pts = reinterpret_cast<float4*>(static_cast<char*>(scratch) +
                                        keys_bytes(Q));
  const int n_tiles = tiles_of(nd);
  const int n_pts = n_tiles * kTile;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_stage = n_pts > Q ? n_pts : Q;
  stage_kernel<<<(n_stage + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(data),
      static_cast<const unsigned char*>(mask), pts, keys, nd, n_pts, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 0) {
    const int per_split = (n_tiles + splits - 1) / splits;
    const dim3 grid((nq + kQB - 1) / kQB, splits);
    nn_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(queries),
                                        pts, keys, nq, n_tiles, per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unpack_kernel<<<(Q + 255) / 256, 256, 0, s>>>(
      keys, static_cast<int*>(idx), static_cast<float*>(d2), Q);
  return static_cast<int>(cudaGetLastError());
}
