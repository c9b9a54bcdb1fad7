// Tent-tap accumulation of a frozen parity-split window: the warped image.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/stackwarp.py:38
// _stack_kernel (stack_accumulate_pallas, :85).
//
// What bounds it on an H100: bytes.  Each output pixel reads its two
// displacements, at most four taps of the window and writes one float, a
// few dozen flops; the window planes (about the image itself) are read once
// from device memory and their re-reads by neighbouring pixels hit L1/L2.
//
// What the design does about it: one thread per output pixel, consecutive
// threads on consecutive pixels of a row, so the displacement loads, the
// tap loads of a row and the store coalesce.  The taps are those of
// dvo::tent_sample, the same function (and summation order) the level and
// fused kernels sample with, instead of the TPU's sweep of all (2r+1)^2
// rolled taps: a tent weight is non-zero for at most two taps per axis.
#include "dvo_common.cuh"

namespace {

constexpr int kStackThreads = 256;

__global__ void __launch_bounds__(kStackThreads) stack_kernel(
    const float* __restrict__ planes, const float* __restrict__ du,
    const float* __restrict__ dv, float* __restrict__ out, long long total,
    int s, int ph, int pw, int hp, int wp, int radius) {
  const long long idx = (long long)blockIdx.x * kStackThreads + threadIdx.x;
  if (idx >= total) return;
  const int npx = hp * wp;
  const long long b = idx / npx;
  const int p = (int)(idx - b * npx);
  const int i = p / wp;
  const int j = p - i * wp;
  const float* pl = planes + (size_t)b * s * s * ph * pw;
  out[idx] = dvo::tent_sample(pl, s, ph, pw, radius, i, j, du[idx], dv[idx]);
}

}  // namespace

extern "C" int dvo_stack_accumulate(
    const float* planes, const float* du, const float* dv, float* out,
    int batch, int s, int ph, int pw, int hp, int wp, int radius,
    void* stream) {
  const long long total = (long long)batch * hp * wp;
  if (total == 0) return 0;
  const long long blocks = (total + kStackThreads - 1) / kStackThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stack_kernel<<<(unsigned)blocks, kStackThreads, 0, st>>>(
      planes, du, dv, out, total, s, ph, pw, hp, wp, radius);
  return static_cast<int>(cudaGetLastError());
}
