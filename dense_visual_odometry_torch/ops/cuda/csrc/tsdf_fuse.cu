// One dense TSDF fusion pass: every voxel of a (D, H, W) volume projects
// into the frame, samples depth and gray at its nearest pixel and folds the
// observation into its running averages, in place.
//
// Replaces: no Pallas kernel.  The JAX package's
// dense_visual_odometry_tpu/models/tsdf.py integrate is plain jnp, which XLA
// fuses into one pass; the port's plain version
// (dense_visual_odometry_torch/models/tsdf.py integrate_plain: the voxel
// coordinates, observe, fuse and three copies) runs as ~40 full-volume
// PyTorch kernels, each moving 0.5-1 GB and writing a temporary.
//
// What bounds it on an H100: bytes.  A pass reads and writes the three
// float32 fields of every voxel (24 bytes) and reads the frame, which sits
// in L2: 3.22 GB at 512^3, about 0.96 ms at 3.35 TB/s.  Its arithmetic (four
// IEEE divisions and some thirty other FP32 operations a voxel) is under
// that bound.
//
// What the design does about it: one thread does four consecutive
// x-voxels (16-byte loads and stores of each field, coalesced along x) where
// W is a multiple of 4 and the fields are 16-byte aligned, else one voxel;
// a grid-stride loop over 32-bit indices, the camera and the configuration
// in registers.  Every field of every voxel is read and written once, the
// voxels out of view too.  The arithmetic is the plain version's, operation
// for operation, in single-rounded float32 (the _rn intrinsics, never
// contracted into an FMA): ((r0 x + r1 y) + r2 z) + t, (fx x_c) / z + cx,
// rintf (torch.round: half to even), the truncation band, the carve, the
// clamps with torch.clamp's NaN propagation and (old w + obs) / max(w', 1),
// so the fields equal the plain version's bit for bit.  The pose, the
// intrinsics and the voxel axes are read from device memory: the launch
// reads nothing back to the host.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Fusion {
  int img_h, img_w;
  float truncation;  // the band at zero depth (m)
  float scale_sq;    // the band's growth with the observed depth squared
  float min_depth;
  float max_weight;
  float carve_keep;  // 1 - carve_decay, rounded to float32
  int carve;         // carve_decay > 0
};

struct Camera {
  float r[9], t[3];
  float fx, fy, cx, cy;
};

// torch.clamp(x, lo, hi), torch.clamp(x, min=lo) and torch.clamp(x, max=hi)
// on CUDA floats: a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max_nan(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

// One voxel at world x = ``xw`` of a row whose y and z products are
// ``py`` = r[i][1] * y and ``pz`` = r[i][2] * z for camera axis i.
__device__ __forceinline__ void fuse_voxel(const Camera& c, const Fusion& f,
                                           const float* __restrict__ depth,
                                           const float* __restrict__ gray, float xw,
                                           const float (&py)[3], const float (&pz)[3],
                                           float& tsdf, float& weight, float& g) {
  const float xc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r[0], xw), py[0]), pz[0]), c.t[0]);
  const float yc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r[3], xw), py[1]), pz[1]), c.t[1]);
  const float zc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.r[6], xw), py[2]), pz[2]), c.t[2]);
  const bool in_front = zc > f.min_depth;
  const float z = in_front ? zc : 1.0f;
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(c.fx, xc), z), c.cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(c.fy, yc), z), c.cy);
  // torch.round then .to(torch.int32): half to even, then a saturating
  // conversion (NaN to 0), as PyTorch's cast compiles.
  const int ui = static_cast<int>(rintf(u));
  const int vi = static_cast<int>(rintf(v));
  bool valid = in_front && ui >= 0 && ui < f.img_w && vi >= 0 && vi < f.img_h;
  float w_old = weight, tsdf_obs = 0.0f, gray_s = 0.0f;
  if (valid) {  // out of view the plain version's sample decides nothing
    const int p = vi * f.img_w + ui;
    const float d = __ldg(depth + p);
    gray_s = __ldg(gray + p);
    const float sdf = __fsub_rn(d, zc);
    const float trunc = __fadd_rn(f.truncation, __fmul_rn(__fmul_rn(f.scale_sq, d), d));
    valid = d > 0.0f && sdf > -trunc;
    tsdf_obs = clamp_nan(__fdiv_rn(sdf, trunc), -1.0f, 1.0f);
    if (f.carve && valid && sdf > trunc && tsdf < 0.25f) w_old = __fmul_rn(w_old, f.carve_keep);
  }
  const float w_new = __fadd_rn(w_old, valid ? 1.0f : 0.0f);
  if (valid) {
    const float w_safe = clamp_min_nan(w_new, 1.0f);
    tsdf = __fdiv_rn(__fadd_rn(__fmul_rn(tsdf, w_old), tsdf_obs), w_safe);
    g = __fdiv_rn(__fadd_rn(__fmul_rn(g, w_old), gray_s), w_safe);
  }
  weight = clamp_max_nan(w_new, f.max_weight);
}

// kVec consecutive x-voxels a thread per step of the grid-stride loop.
template <int kVec>
__global__ void __launch_bounds__(kThreads) tsdf_fuse_kernel(
    float* __restrict__ tsdf, float* __restrict__ weight, float* __restrict__ gray_vol,
    const float* __restrict__ depth, const float* __restrict__ gray,
    const float* __restrict__ intrinsics, const float* __restrict__ world_to_cam,
    const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ zs,
    int h, int w, unsigned items, Fusion f) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.r[3 * i + j] = __ldg(world_to_cam + 4 * i + j);
    c.t[i] = __ldg(world_to_cam + 4 * i + 3);
  }
  c.fx = __ldg(intrinsics + 0);
  c.cx = __ldg(intrinsics + 2);
  c.fy = __ldg(intrinsics + 4);
  c.cy = __ldg(intrinsics + 5);
  // Unsigned: the last stride may step past 2^31 - 1.
  for (unsigned item = blockIdx.x * kThreads + threadIdx.x; item < items;
       item += gridDim.x * kThreads) {
    const int idx = static_cast<int>(item) * kVec;  // the first voxel's flat index, < 2^31
    const int row = idx / w;
    const int x = idx - row * w;
    const int zi = row / h;
    const int yi = row - zi * h;
    const float yw = __ldg(ys + yi), zw = __ldg(zs + zi);
    float py[3], pz[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      py[i] = __fmul_rn(c.r[3 * i + 1], yw);
      pz[i] = __fmul_rn(c.r[3 * i + 2], zw);
    }
    if constexpr (kVec == 4) {
      float4 t4 = *reinterpret_cast<const float4*>(tsdf + idx);
      float4 w4 = *reinterpret_cast<const float4*>(weight + idx);
      float4 g4 = *reinterpret_cast<const float4*>(gray_vol + idx);
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(xs + x));
      fuse_voxel(c, f, depth, gray, x4.x, py, pz, t4.x, w4.x, g4.x);
      fuse_voxel(c, f, depth, gray, x4.y, py, pz, t4.y, w4.y, g4.y);
      fuse_voxel(c, f, depth, gray, x4.z, py, pz, t4.z, w4.z, g4.z);
      fuse_voxel(c, f, depth, gray, x4.w, py, pz, t4.w, w4.w, g4.w);
      *reinterpret_cast<float4*>(tsdf + idx) = t4;
      *reinterpret_cast<float4*>(weight + idx) = w4;
      *reinterpret_cast<float4*>(gray_vol + idx) = g4;
    } else {
      float t1 = tsdf[idx], w1 = weight[idx], g1 = gray_vol[idx];
      fuse_voxel(c, f, depth, gray, __ldg(xs + x), py, pz, t1, w1, g1);
      tsdf[idx] = t1;
      weight[idx] = w1;
      gray_vol[idx] = g1;
    }
  }
}

}  // namespace

// Fuse one (img_h, img_w) frame into the (d, h, w) fields in place.
// ``intrinsics`` is the 3x3 K, ``world_to_cam`` the 4x4 inverse pose, both
// row-major float32 on the device; ``xs``, ``ys``, ``zs`` the voxel centres'
// world coordinates (w, h and d floats).  ``vec``: w % 4 == 0 and the fields
// and ``xs`` 16-byte aligned.  The wrapper keeps d * h * w below 2^31.
extern "C" int dvo_tsdf_fuse(float* tsdf, float* weight, float* gray_vol, const float* depth,
                             const float* gray, const float* intrinsics,
                             const float* world_to_cam, const float* xs, const float* ys,
                             const float* zs, int d, int h, int w, int img_h, int img_w,
                             float truncation, float scale_sq, float min_depth, float max_weight,
                             float carve_keep, int carve, int vec, void* stream) {
  const long long voxels = static_cast<long long>(d) * h * w;
  if (voxels == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Fusion f{img_h, img_w, truncation, scale_sq, min_depth, max_weight, carve_keep, carve};
  const unsigned items = static_cast<unsigned>(vec ? voxels / 4 : voxels);
  const int blocks = static_cast<int>(
      std::min<long long>((items + kThreads - 1) / kThreads,
                          static_cast<long long>(sms) * kBlocksPerSm));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    tsdf_fuse_kernel<4><<<blocks, kThreads, 0, s>>>(tsdf, weight, gray_vol, depth, gray,
                                                    intrinsics, world_to_cam, xs, ys, zs, h, w,
                                                    items, f);
  } else {
    tsdf_fuse_kernel<1><<<blocks, kThreads, 0, s>>>(tsdf, weight, gray_vol, depth, gray,
                                                    intrinsics, world_to_cam, xs, ys, zs, h, w,
                                                    items, f);
  }
  return static_cast<int>(cudaGetLastError());
}
