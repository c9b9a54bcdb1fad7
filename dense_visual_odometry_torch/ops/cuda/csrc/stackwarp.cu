// Tent-tap accumulation of a frozen parity-split window: the warped image.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/stackwarp.py:38
// _stack_kernel (stack_accumulate_pallas, :85).
//
// What bounds it on an H100: bytes, and at the main path's sizes the
// latency of two dependent trips to memory (the displacements, then the
// taps they point at).  Each output pixel reads its two displacements, at
// most four taps of the window and writes one float, a few dozen flops;
// the window planes (about the image itself) are read once from device
// memory and their re-reads by neighbouring pixels hit L1/L2.  The first
// design spent its time on index arithmetic (a 64-bit division and two
// 32-bit ones per pixel, a runtime % and / per tap) and kept few loads in
// flight.
//
// What the design does about it: a 3-D grid (32-column x 8-row blocks x
// batch) gives each thread its row, column and element with no division,
// in 32-bit arithmetic; a warp covers 32 consecutive pixels of a row, so
// the displacement loads and the store coalesce; the ragged edge (a grid
// width or height that is no multiple of 32 or 8, e.g. 214 at stride 3
// on 640 columns) is masked.  The taps are dvo::tent_sample<S>, at strides
// 1 and 2 known at compile time (parity plane and plane column by mask
// and shift), at every stride >= 3 read at run time (kRuntimeStride: a
// division per tap offset), which loads all four taps of a
// pixel through the read-only path before it adds any; it is the same
// function and summation order the level and fused kernels sample the
// window with, instead of the TPU's sweep of all (2r+1)^2 rolled taps.
// One pixel per thread keeps four times as many threads in flight as four
// pixels per thread with 16-byte loads and stores, which measured slower
// at B <= 8 on the card and no faster at B=64 (PERF.md).
#include "dvo_common.cuh"

namespace {

constexpr int kBlockX = 32, kBlockY = 8;  // threads: 32 columns x 8 rows

template <int S>
__global__ void __launch_bounds__(kBlockX * kBlockY) stack_kernel(
    const float* __restrict__ planes, const float* __restrict__ du,
    const float* __restrict__ dv, float* __restrict__ out,
    int s, int ph, int pw, int hp, int wp, int radius) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= hp || j >= wp) return;
  const int p = (b * hp + i) * wp + j;
  const int ss = dvo::grid_stride<S>(s);
  out[p] = dvo::tent_sample<S>(planes + b * (ss * ss * ph * pw), ph, pw, radius, radius, i, j,
                               __ldg(du + p), __ldg(dv + p), s);
}

}  // namespace

// The wrapper keeps batch * s^2 * ph * pw and batch * hp * wp below 2^31
// and batch at most 65535.  Every stride s >= 1 has a variant; s < 1 is an
// error.
extern "C" int dvo_stack_accumulate(
    const float* planes, const float* du, const float* dv, float* out,
    int batch, int s, int ph, int pw, int hp, int wp, int radius,
    void* stream) {
  if (batch == 0 || hp == 0 || wp == 0) return 0;
  const dim3 grid((wp + kBlockX - 1) / kBlockX, (hp + kBlockY - 1) / kBlockY, batch);
  const dim3 block(kBlockX, kBlockY, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 1)
    stack_kernel<1><<<grid, block, 0, st>>>(planes, du, dv, out, s, ph, pw, hp, wp, radius);
  else if (s == 2)
    stack_kernel<2><<<grid, block, 0, st>>>(planes, du, dv, out, s, ph, pw, hp, wp, radius);
  else if (s >= 3)
    stack_kernel<dvo::kRuntimeStride><<<grid, block, 0, st>>>(planes, du, dv, out, s, ph, pw, hp,
                                                             wp, radius);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
