// One image-pyramid step: the 3x3 median (replicated borders) at the kept
// pixels only, median3x3(x)[..., ::2, ::2].
//
// Replaces: no Pallas kernel.  The JAX package's
// dense_visual_odometry_tpu/ops/pyramid.py builds its pyramid in plain jnp,
// which XLA fuses into one pass; the port's plain version
// (dense_visual_odometry_torch/ops/pyramid.py median3x3) runs the same
// 19-exchange network as two full-plane PyTorch kernels an exchange, 40 a
// level with the padding and the decimation, each reading two planes and
// writing one, three quarters of it thrown away.
//
// What bounds it on an H100: bytes.  A level reads its input once and
// writes a quarter of it: (1 + 1/4) * 4 bytes an input pixel over
// 3.35 TB/s, about 0.12 ms at 256 x 480 x 640.  The 19 exchanges are a
// hundred-odd instructions an output pixel, under that bound.
//
// What the design does about it: one thread an output pixel on a 3-D grid
// (32-column x 8-row blocks x the flattened leading dims), no index
// division, 32-bit indices.  A thread loads the 3x3 neighbourhood centred
// on (2y, 2x) with its indices clamped to the plane (the replicated
// border, so no padded copy is made); the rows and columns it shares with
// its neighbours come from L1, so each input pixel leaves device memory
// about once.  The nine values stay in registers through the same 19
// exchanges in the same order as median3x3, with torch.minimum /
// torch.maximum's NaN propagation (a NaN on either side gives NaN), so the
// output equals the plain version's element for element.  The output is
// the only memory it writes.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 8;  // threads: 32 columns x 8 rows

// torch.minimum / torch.maximum on CUDA floats.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void cx(float& a, float& b) {
  const float lo = nan_min(a, b);
  const float hi = nan_max(a, b);
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(kBlockX * kBlockY) median_pyr_down_kernel(
    const float* __restrict__ in, float* __restrict__ out, int h, int w, int ho, int wo) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= wo || y >= ho) return;
  const float* plane = in + blockIdx.z * (h * w);
  // 2y <= h - 1 and 2x <= w - 1: only the outer taps need clamping.
  const int r0 = max(2 * y - 1, 0) * w, r1 = 2 * y * w, r2 = min(2 * y + 1, h - 1) * w;
  const int c0 = max(2 * x - 1, 0), c1 = 2 * x, c2 = min(2 * x + 1, w - 1);
  // p[3 * dy + dx]: the order of median3x3's shifted planes.
  float p[9] = {__ldg(plane + r0 + c0), __ldg(plane + r0 + c1), __ldg(plane + r0 + c2),
                __ldg(plane + r1 + c0), __ldg(plane + r1 + c1), __ldg(plane + r1 + c2),
                __ldg(plane + r2 + c0), __ldg(plane + r2 + c1), __ldg(plane + r2 + c2)};
  cx(p[1], p[2]); cx(p[4], p[5]); cx(p[7], p[8]);
  cx(p[0], p[1]); cx(p[3], p[4]); cx(p[6], p[7]);
  cx(p[1], p[2]); cx(p[4], p[5]); cx(p[7], p[8]);
  cx(p[0], p[3]); cx(p[5], p[8]); cx(p[4], p[7]);
  cx(p[3], p[6]); cx(p[1], p[4]); cx(p[2], p[5]);
  cx(p[4], p[7]); cx(p[4], p[2]); cx(p[6], p[4]);
  cx(p[4], p[2]);
  out[blockIdx.z * (ho * wo) + y * wo + x] = p[4];
}

}  // namespace

// (lead, h, w) -> (lead, ceil(h / 2), ceil(w / 2)).  The wrapper keeps
// lead * h * w below 2^31 and lead at most 65535.
extern "C" int dvo_median_pyr_down(const float* in, float* out, int lead, int h, int w,
                                   void* stream) {
  if (lead == 0 || h == 0 || w == 0) return 0;
  const int ho = (h + 1) / 2, wo = (w + 1) / 2;
  const dim3 grid((wo + kBlockX - 1) / kBlockX, (ho + kBlockY - 1) / kBlockY, lead);
  const dim3 block(kBlockX, kBlockY, 1);
  median_pyr_down_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w,
                                                                                ho, wo);
  return static_cast<int>(cudaGetLastError());
}
