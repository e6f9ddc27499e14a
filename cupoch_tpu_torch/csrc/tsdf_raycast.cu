// The TSDF raycast's per-ray work for Hopper (sm_90a), bound to Python with
// ctypes: one thread marches a pixel's ray and refines its crossing.
//
// Replaces no TPU kernel: the JAX package's march is a `lax.while_loop` of
// XLA ops (`cupoch_tpu/integration/tsdf_ops.py:195`). The port's plain
// version (`integration/tsdf_ops.raycast_plain`) runs one march step as
// about 35 PyTorch ops over every pixel of the image, stopped rays included,
// with a blocking read of "has every ray stopped" every 16 steps: about
// 9,000 launches and 16 host reads a level. It was added for the
// benchmark's `kinfu640.handheld` cell, where the four plain raycasts held
// 80% of a traced frame, and each level cost about the same whatever its
// pixel count: launches, not work, set the pace. This kernel does one
// launch a level, only the live rays' work, and reads nothing back but the
// steps the slowest ray took.
//
// What it computes, for each pixel (the wrapper is
// `integration/tsdf_ops.raycast`; `raycast_plain` is the plain version,
// which also sets up every ray's direction, entry time `ray0` and exit
// time `t_far`, and normalises the gradient and masks the misses after):
//   - the march: the sample at rel_o + dir * ray0, then for i = 0, 1, ..:
//     ray_len = ray0 + float(i) * step, the nearest voxel of
//     rel_o + dir * (ray_len + step), in the grid when its index lies in
//     [1, R - 2] on every axis; a +/- change between in-grid samples is a
//     hit at t_lo = ray_len, a -/+ change a back face; the ray stops at
//     either or once ray_len >= t_far, after max_steps at the latest;
//   - for a hit, the trilinear samples at t_lo + k * step, k = -1 ..
//     refine_steps, the first +/- segment (or k = 0's), the crossing
//     t_star between its ends when the segment is sound, the point
//     o + dir * t_star, the central trilinear gradient at it (2 vl apart),
//     and the nearest voxel's colour;
//   - outputs: the point, the unnormalised gradient, the colour, the hit
//     flag (false where a segment mixes unobserved voxels), and the steps
//     its march took (max_steps + 1 where it never stopped) folded into
//     one int with atomicMax.
// Every operation is rounded on its own (__fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn), in the plain version's order, so that nvcc
// contracts nothing into an FMA and the two agree bit for bit. Once a ray
// has stopped the plain loop changes nothing of its hit, so a thread leaves
// its loop at its own stop.
//
// Bound: bytes. A march step gathers one 4-byte voxel a ray; a hit then
// reads the refinement's 6 x 8 corners of tsdf and weight (8 B each), the
// gradient's 6 x 8 tsdf corners (4 B), 12 B of colour, and every ray
// writes 40 B (point, gradient, colour, flag). At level 0 (307k rays,
// about 100-250 steps) that is under 0.3 GB, most of it in L2, since
// neighbouring rays sample neighbouring voxels.
//
// Design. One thread a pixel, in blocks of 32 x 4 pixels, so that a warp's
// rays are one row of neighbours and their samples share sectors. A
// sample's position depends only on i, not on the sample before, so the
// march issues kAhead gathers before it tests the first of them: the loads
// of a group are in flight together and hide the gather's latency. Loads
// past a ray's stop read clamped in-grid voxels whose values are dropped.
// A warp folds its rays' steps with a reduction before one atomicMax.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;     // pixels a warp, along a row
constexpr int kTileH = 4;      // warps a block
constexpr int kAhead = 8;      // march steps whose gathers issue together

// rel_o = o - origin, o the camera centre, origin the grid's min corner,
// in the order of the wrapper's parameter vector
struct Params {
  float o[3], org[3], rel[3], vl, inv_vl, step;
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}

// An integer-valued float as an index clamped to [0, top]: the plain
// version's `.to(torch.int64).clamp(0, top)` wherever the index is read
// (NaN goes to 0, as fmaxf drops it).
__device__ __forceinline__ int clamp_index(float g, float top) {
  return static_cast<int>(fminf(fmaxf(g, 0.0f), top));
}

// The nearest voxel's tsdf of the ray's sample at time s, and whether its
// index lies in [1, R - 2] on every axis (tested on the float: the floor
// is integer-valued, so the test agrees with the plain version's on the
// int64 index, saturation and NaN included).
__device__ __forceinline__ float nearest(const float* __restrict__ tsdf,
                                         const Params& p, const float d[3],
                                         float s, int R, bool& inb) {
  const float top = static_cast<float>(R - 1);
  float g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    g[c] = floorf(fmul(fadd(p.rel[c], fmul(d[c], s)), p.inv_vl));
  inb = g[0] >= 1.0f && g[0] < top && g[1] >= 1.0f && g[1] < top &&
        g[2] >= 1.0f && g[2] < top;
  const unsigned idx =
      (static_cast<unsigned>(clamp_index(g[0], top)) * R +
       clamp_index(g[1], top)) * R + clamp_index(g[2], top);
  return __ldg(tsdf + idx);
}

// Trilinear tsdf at the world point x, the corners' terms summed in the
// plain version's order; with obs, whether all 8 corners are observed
// (weight > 0).
__device__ __forceinline__ float trilinear(const float* __restrict__ tsdf,
                                           const float* __restrict__ weight,
                                           const Params& p, const float x[3],
                                           int R, bool* obs) {
  float r[3];
  int gi[3];
  const float top = static_cast<float>(R - 2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = fsub(fmul(fsub(x[c], p.org[c]), p.inv_vl), 0.5f);
    const float g0 = floorf(g);
    r[c] = fsub(g, g0);
    gi[c] = clamp_index(g0, top);
  }
  float val = 0.0f;
  float wmin = __int_as_float(0x7f800000);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float wx = dx ? r[0] : fsub(1.0f, r[0]);
        const float wy = dy ? r[1] : fsub(1.0f, r[1]);
        const float wz = dz ? r[2] : fsub(1.0f, r[2]);
        const unsigned idx =
            (static_cast<unsigned>(gi[0] + dx) * R + (gi[1] + dy)) * R +
            (gi[2] + dz);
        val = fadd(val, fmul(fmul(fmul(wx, wy), wz), __ldg(tsdf + idx)));
        if (obs != nullptr) wmin = fminf(wmin, __ldg(weight + idx));
      }
  if (obs != nullptr) *obs = wmin > 0.0f;
  return val;
}

__global__ void __launch_bounds__(kTileW * kTileH)
    raycast_kernel(const float* __restrict__ tsdf,
                   const float* __restrict__ weight,
                   const float* __restrict__ color,
                   const float* __restrict__ dirs,
                   const float* __restrict__ ray0,
                   const float* __restrict__ t_far,
                   const Params* __restrict__ params,
                   float* __restrict__ pts_out, float* __restrict__ grad_out,
                   float* __restrict__ col_out, bool* __restrict__ hit_out,
                   int* __restrict__ steps_out, int H, int W, int R,
                   int max_steps, int refine_steps) {
  const int u = blockIdx.x * kTileW + threadIdx.x;
  const int v = blockIdx.y * kTileH + threadIdx.y;
  int stop = 0;   // the steps this ray's march took; 0 off the image
  if (u < W && v < H) {
    const Params p = *params;
    const size_t ray = static_cast<size_t>(v) * W + u;
    const float d[3] = {dirs[3 * ray], dirs[3 * ray + 1], dirs[3 * ray + 2]};
    const float r0 = ray0[ray];
    const float tf = t_far[ray];
    const float step = p.step;

    // the march
    bool inb;
    float f = nearest(tsdf, p, d, r0, R, inb);
    if (!inb) f = 0.0f;
    float t_lo = 0.0f;
    bool found = false, stopped = false;
    stop = max_steps + 1;
    for (int i0 = 0; i0 < max_steps && !stopped; i0 += kAhead) {
      float fv[kAhead], rl[kAhead];
      bool in[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        rl[j] = fadd(r0, fmul(static_cast<float>(i0 + j), step));
        fv[j] = nearest(tsdf, p, d, fadd(rl[j], step), R, in[j]);
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (!stopped && i0 + j < max_steps) {
          const bool hit = in[j] && f > 0.0f && fv[j] < 0.0f;
          if (hit) {
            t_lo = rl[j];
            found = true;
          }
          if (hit || (in[j] && f < 0.0f && fv[j] > 0.0f) || rl[j] >= tf) {
            stopped = true;
            stop = i0 + j + 1;
          }
          if (in[j]) f = fv[j];
        }
      }
    }

    // the refinement of a hit: segment k joins the samples at k and k + 1
    float pt[3] = {0.0f, 0.0f, 0.0f}, grad[3] = {0.0f, 0.0f, 0.0f},
          col[3] = {0.0f, 0.0f, 0.0f};
    if (found) {
      auto at = [&](int k) {
        return fadd(t_lo, fmul(static_cast<float>(k), step));
      };
      auto sample = [&](int k, bool* obs) {
        const float t = at(k);
        const float x[3] = {fadd(p.o[0], fmul(d[0], t)),
                            fadd(p.o[1], fmul(d[1], t)),
                            fadd(p.o[2], fmul(d[2], t))};
        return trilinear(tsdf, weight, p, x, R, obs);
      };
      bool oa, ob, o1;
      float fa = sample(-1, &oa);
      float fb = sample(0, &ob);
      const float f1 = sample(1, &o1);
      // no +/- segment: k = 0's
      float seg_t = t_lo, flo = fb, fhi = f1;
      bool seg_obs = ob && o1;
      for (int k = -1; k < refine_steps; ++k) {
        if (k >= 0) {
          fa = fb;
          oa = ob;
          if (k == 0) {
            fb = f1;
            ob = o1;
          } else {
            fb = sample(k + 1, &ob);
          }
        }
        if (fa > 0.0f && fb <= 0.0f) {
          seg_t = at(k);
          flo = fa;
          fhi = fb;
          seg_obs = oa && ob;
          break;
        }
      }
      // a segment that is not sound, or mixes unobserved voxels, is a miss
      // (the plain version's t_star there is masked)
      found = flo > 0.0f && fhi < 0.0f && fabsf(fsub(flo, fhi)) > 1e-12f &&
              seg_obs;
      if (found) {
        const float t_star =
            fadd(seg_t, __fdiv_rn(fmul(step, flo), fsub(flo, fhi)));
#pragma unroll
        for (int c = 0; c < 3; ++c) pt[c] = fadd(p.o[c], fmul(d[c], t_star));
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float xp[3], xm[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float e = c == a ? p.vl : 0.0f;
            xp[c] = fadd(pt[c], e);
            xm[c] = fsub(pt[c], e);
          }
          grad[a] = fsub(trilinear(tsdf, weight, p, xp, R, nullptr),
                         trilinear(tsdf, weight, p, xm, R, nullptr));
        }
        // the nearest voxel: truncation, as `.to(torch.int64)` does
        const float top = static_cast<float>(R - 1);
        int ci[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          ci[c] = clamp_index(
              fsub(fmul(fsub(pt[c], p.org[c]), p.inv_vl), 0.5f), top);
        const size_t cv =
            3 * ((static_cast<size_t>(ci[0]) * R + ci[1]) * R + ci[2]);
#pragma unroll
        for (int c = 0; c < 3; ++c) col[c] = __ldg(color + cv + c);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pts_out[3 * ray + c] = pt[c];
      grad_out[3 * ray + c] = grad[c];
      col_out[3 * ray + c] = col[c];
    }
    hit_out[ray] = found;
  }
  // a warp is one row of the block: fold its steps, then one atomic
  stop = __reduce_max_sync(0xffffffffu, stop);
  if (threadIdx.x == 0 && stop > 0) atomicMax(steps_out, stop);
}

}  // namespace

// Launches the raycast of an H x W image on `stream`; returns
// cudaGetLastError() (0 when the launch was accepted). Device pointers to
// contiguous f32 tensors: tsdf and weight [R, R, R], color [R, R, R, 3],
// dirs [H, W, 3], ray0 and t_far [H, W], params the 12 floats (o, origin,
// rel_o, vl, inv_vl, step); outputs pts, grad and col [H, W, 3] f32, hit
// [H, W] bool, steps one int32 (set here to the most steps a ray's march
// took, max_steps + 1 where one never stopped, 0 for an empty image).
extern "C" int tsdf_raycast_launch(const void* tsdf, const void* weight,
                                   const void* color, const void* dirs,
                                   const void* ray0, const void* t_far,
                                   const void* params, void* pts, void* grad,
                                   void* col, void* hit, void* steps, int H,
                                   int W, int R, int max_steps,
                                   int refine_steps, void* stream) {
  if (H < 0 || W < 0 || R < 3 || max_steps < 0 || refine_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(steps, 0, sizeof(int), s);
  if (err != cudaSuccess || H == 0 || W == 0) return static_cast<int>(err);
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  raycast_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(tsdf), static_cast<const float*>(weight),
      static_cast<const float*>(color), static_cast<const float*>(dirs),
      static_cast<const float*>(ray0), static_cast<const float*>(t_far),
      static_cast<const Params*>(params), static_cast<float*>(pts),
      static_cast<float*>(grad), static_cast<float*>(col),
      static_cast<bool*>(hit), static_cast<int*>(steps), H, W, R, max_steps,
      refine_steps);
  return static_cast<int>(cudaGetLastError());
}
