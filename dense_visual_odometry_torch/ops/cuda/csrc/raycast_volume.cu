// The volume march: a virtual (depth, gray) view of a dense TSDF volume,
// one thread per pixel's ray, marched through the volume's box only.
//
// Replaces: no Pallas kernel.  The JAX package renders with plain jnp
// (dense_visual_odometry_tpu/models/tsdf.py raycast_view_march), and the
// port's plain version (dense_visual_odometry_torch/models/tsdf.py
// raycast_view_march_volume_plain) runs as ~800 PyTorch kernels a render at
// 640x480: a gated copy of the whole tsdf field (134 M voxels at 512^3), the
// rays and their slab-test entry, chunks of 32 steps over every ray with
// (32, 3, rays) temporaries, and 8-corner trilinear gathers for the two
// sphere-tracing steps and the gray.
//
// What bounds it on an H100: bytes, and the latency of dependent reads.  A
// ray reads the tsdf and the weight of one voxel a step up to its first
// crossing, then 3 x 8 trilinear taps.  Rays of neighbouring pixels sample
// neighbouring voxels, so the distinct voxels of a render are few: about 3 M
// at 512^3 and 640x480, whose tsdf and weight, the gray at the hits (~0.5 M
// voxels) and the two output images make ~29 MB, 9 us at 3.35 TB/s.  That is
// far under the time a ray spends waiting on its chain of ~100 reads, each a
// load from L2 or HBM.
//
// What the design does about it: a thread a ray, in 16 x 8-pixel blocks so
// that a warp's rays are close in space and share cache sectors as they
// march; the march samples kBatch steps ahead before it tests them in order,
// so that a thread has several reads in flight (4 steps: 0.082 ms a render
// at 512^3 against 0.118 with 1, 0.093 with 2, 0.082 with 8); a ray stops at
// its first crossing (the plain version's crossing is sticky, so it returns
// the same); a sample outside the box reads no memory, and a ray that has
// left the box marches on to n_steps (a stop there measured slower, 0.137
// ms); no gated copy of the field is made: the gate (weight >= min_weight ?
// tsdf : 1) is applied to each voxel read.  The arithmetic is the plain version's, operation for
// operation, in single-rounded float32 (the _rn intrinsics, never contracted
// into an FMA): the ray from the intrinsics and the pose, the slab test with
// its parallel-ray case, base + slope * t rounded half to even (rintf, as
// torch.round), the entry sample with no predecessor and t = t_in + dt * i,
// the linear localisation with its 1e-6 clamp, two refinements on the
// trilinear field (corners in dz, dy, dx order, weights (wx * wy) * wz,
// accumulated from zero) and the trilinear gray.  A division by a Python
// float is PyTorch's multiplication by its float32 reciprocal on CUDA
// tensors, so the kernel multiplies by ``inv_voxel``.  The intrinsics and
// the pose are read from device memory: the launch reads nothing back to
// the host.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kBatch = 4;  // march samples in flight per thread

struct Volume {
  const float* __restrict__ tsdf;
  const float* __restrict__ weight;
  const float* __restrict__ gray;
  int d, h, w;
  float top[3];     // w - 1, h - 1, d - 1 (x, y, z)
  float lo[3];      // the box's lowest corner (world x, y, z)
  float hi[3];      // its highest corner
  float inv_voxel;  // float32 1 / voxel size
  float min_weight;
};

struct March {
  int n_steps;
  float step;  // dt
  float min_depth, max_depth;
  float truncation, scale_sq;
};

struct Ray {
  float o[3];      // camera centre (world)
  float dw[3];     // world direction scaled so that t is camera depth
  float base[3];   // voxel coordinates of the centre
  float slope[3];  // voxel coordinates per unit t
};

// torch.minimum / torch.maximum on CUDA floats: a NaN in either wins.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.clamp(x, lo, hi) and torch.clamp(x, min=lo): a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) { return min(max(x, lo), hi); }

// The field the march reads: unobserved or low-confidence voxels are free
// space.
__device__ __forceinline__ float gated(const Volume& v, int idx) {
  const float wt = __ldg(v.weight + idx);
  const float ts = __ldg(v.tsdf + idx);
  return wt >= v.min_weight ? ts : 1.0f;
}

// The nearest-voxel sample at ``t``: free space outside the box.
__device__ __forceinline__ float sample_nearest(const Volume& v, const Ray& r, float t) {
  bool inside = true;
  int idx[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = rintf(__fadd_rn(r.base[a], __fmul_rn(r.slope[a], t)));
    inside = inside && f >= 0.0f && f <= v.top[a];
    idx[a] = static_cast<int>(f);
  }
  if (!inside) return 1.0f;
  return gated(v, (idx[2] * v.h + idx[1]) * v.w + idx[0]);
}

// The field (gated, or the raw gray) sampled trilinearly along the ray at
// ``t``: trilinear_corners and trilinear_sample of models/tsdf.py.
template <bool kGated>
__device__ float trilinear(const Volume& v, const Ray& r, float t) {
  float w1[3];
  int i0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = __fadd_rn(r.o[a], __fmul_rn(r.dw[a], t));
    const float f = __fsub_rn(__fmul_rn(__fsub_rn(p, v.lo[a]), v.inv_voxel), 0.5f);
    const float f0 = floorf(f);
    w1[a] = __fsub_rn(f, f0);
    i0[a] = static_cast<int>(f0);
  }
  const int top[3] = {v.w - 1, v.h - 1, v.d - 1};
  float acc = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? w1[0] : __fsub_rn(1.0f, w1[0]);
        const float wy = dy ? w1[1] : __fsub_rn(1.0f, w1[1]);
        const float wz = dz ? w1[2] : __fsub_rn(1.0f, w1[2]);
        const float wgt = __fmul_rn(__fmul_rn(wx, wy), wz);
        const int ix = clamp_int(i0[0] + dx, 0, top[0]);
        const int iy = clamp_int(i0[1] + dy, 0, top[1]);
        const int iz = clamp_int(i0[2] + dz, 0, top[2]);
        const int idx = iz * (v.h * v.w) + iy * v.w + ix;
        const float val = kGated ? gated(v, idx) : __ldg(v.gray + idx);
        acc = __fadd_rn(acc, __fmul_rn(wgt, val));
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kBlockX * kBlockY) raycast_volume_kernel(
    Volume v, March m, const float* __restrict__ intrinsics, const float* __restrict__ pose,
    float* __restrict__ depth_out, float* __restrict__ gray_out, int img_h, int img_w) {
  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int row = blockIdx.y * kBlockY + threadIdx.y;
  if (col >= img_w || row >= img_h) return;

  // pixel_rays: the camera-frame ray (dx, dy, 1) rotated into the world.
  const float fx = __ldg(intrinsics + 0), cx = __ldg(intrinsics + 2);
  const float fy = __ldg(intrinsics + 4), cy = __ldg(intrinsics + 5);
  const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(col), cx), fx);
  const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(row), cy), fy);
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float r0 = __ldg(pose + 4 * a), r1 = __ldg(pose + 4 * a + 1);
    const float r2 = __ldg(pose + 4 * a + 2);
    r.o[a] = __ldg(pose + 4 * a + 3);
    r.dw[a] = __fadd_rn(__fadd_rn(__fmul_rn(r0, dx), __fmul_rn(r1, dy)), r2);
    r.base[a] = __fsub_rn(__fmul_rn(__fsub_rn(r.o[a], v.lo[a]), v.inv_voxel), 0.5f);
    r.slope[a] = __fmul_rn(r.dw[a], v.inv_voxel);
  }

  // volume_ray_entry: the slab test, clipped to [min_depth, max_depth].
  float entry = m.min_depth;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = r.dw[a];
    const bool flat = d == 0.0f;
    const float safe = flat ? 1.0f : d;
    float near = min_nan(__fdiv_rn(__fsub_rn(v.lo[a], r.o[a]), safe),
                         __fdiv_rn(__fsub_rn(v.hi[a], r.o[a]), safe));
    if (flat) {  // a ray parallel to a slab enters it nowhere or everywhere
      const bool outside = r.o[a] < v.lo[a] || r.o[a] > v.hi[a];
      near = outside ? __int_as_float(0x7f800000) : __int_as_float(0xff800000);
    }
    entry = max_nan(entry, near);
  }
  const float t_in = clamp_nan(entry, m.min_depth, m.max_depth);

  // The march: samples i = 0..n_steps at t_in + dt * i; the first
  // positive-to-negative crossing, localised linearly.
  bool found = false;
  float t_hit = 0.0f;
  if (m.n_steps > 0) {
    float t_prev = __fadd_rn(t_in, __fmul_rn(m.step, 0.0f));
    float phi_prev = sample_nearest(v, r, t_prev);
    for (int i = 1; !found && i <= m.n_steps; i += kBatch) {
      float ts[kBatch], phis[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        ts[j] = __fadd_rn(t_in, __fmul_rn(m.step, static_cast<float>(i + j)));
        phis[j] = sample_nearest(v, r, ts[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (found || i + j > m.n_steps) break;
        if (phis[j] < 0.0f && phi_prev >= 0.0f) {
          const float denom = clamp_min_nan(__fsub_rn(phi_prev, phis[j]),
                                            static_cast<float>(1e-6));
          t_hit = __fadd_rn(t_prev, __fdiv_rn(__fmul_rn(__fsub_rn(ts[j], t_prev), phi_prev),
                                              denom));
          found = true;
        }
        phi_prev = phis[j];
        t_prev = ts[j];
      }
    }
  }

  // _surface: a ray whose first sample is already behind a surface is
  // invalid; two sphere-tracing steps, then the gray at the hit.
  const int p = row * img_w + col;
  if (!(found && t_hit > m.min_depth)) {
    depth_out[p] = 0.0f;
    gray_out[p] = 0.0f;
    return;
  }
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const float tau = __fadd_rn(__fmul_rn(__fmul_rn(m.scale_sq, t_hit), t_hit), m.truncation);
    const float phi = trilinear<true>(v, r, t_hit);
    t_hit = __fadd_rn(t_hit, __fmul_rn(clamp_nan(phi, -0.5f, 0.5f), tau));
  }
  depth_out[p] = t_hit;
  gray_out[p] = trilinear<false>(v, r, t_hit);
}

}  // namespace

// Render an (img_h, img_w) view of the (d, h, w) volume (tsdf, weight,
// gray): ``intrinsics`` the 3x3 K and ``pose`` the 4x4 camera-to-world, both
// row-major float32 on the device; ``depth_out`` and ``gray_out`` (img_h,
// img_w) float32, written whole (0 where no surface).  ``lo`` / ``hi`` the
// box's corners and ``inv_voxel`` the float32 reciprocal of the voxel size,
// as the plain version rounds them.  The wrapper keeps d * h * w below 2^31.
extern "C" int dvo_raycast_volume(const float* tsdf, const float* weight, const float* gray,
                                  const float* intrinsics, const float* pose, float* depth_out,
                                  float* gray_out, int d, int h, int w, int img_h, int img_w,
                                  int n_steps, float step, float inv_voxel, float lo_x,
                                  float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
                                  float min_weight, float min_depth, float max_depth,
                                  float truncation, float scale_sq, void* stream) {
  if (img_h <= 0 || img_w <= 0) return 0;
  const Volume v{tsdf,
                 weight,
                 gray,
                 d,
                 h,
                 w,
                 {static_cast<float>(w - 1), static_cast<float>(h - 1), static_cast<float>(d - 1)},
                 {lo_x, lo_y, lo_z},
                 {hi_x, hi_y, hi_z},
                 inv_voxel,
                 min_weight};
  const March m{n_steps, step, min_depth, max_depth, truncation, scale_sq};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((img_w + kBlockX - 1) / kBlockX, (img_h + kBlockY - 1) / kBlockY);
  raycast_volume_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      v, m, intrinsics, pose, depth_out, gray_out, img_h, img_w);
  return static_cast<int>(cudaGetLastError());
}
