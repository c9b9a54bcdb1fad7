// Device code shared by the level-solver, fused-iteration and stack-warp
// kernels.
//
// The level and fused kernels evaluate the same per-pixel photometric model
// over the strided template grid of one batch element: sample the frozen
// window around the integer centre (cu, cv), form the residual against the
// template, take out the illumination pre-fit ("bias": the valid mean;
// "affine", level kernel only: also the gain against the centred
// template), run the t-distribution scale fixed point and reduce the
// weighted 6x6 normal equations.  The pieces here are that evaluation; each
// kernel adds only its own front end (the level kernel warps the template
// points itself, the fused kernel reads precomputed displacements) and its
// own epilogue.  The stack-warp kernel is tent_sample alone.
//
// Arithmetic follows the Pallas kernels operation for operation; the only
// intended difference is the order of the block-wide sums.  Build without
// --use_fast_math and with -fmad=false: the solver relies on NaN-poisoned
// points failing every comparison and on IEEE floor, sqrt and division.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dvo {

constexpr int kThreads = 512;  // one block of kThreads per batch element
constexpr int kWarps = kThreads / 32;
// Largest number of block-wide sums one reduction carries: H (21) + b (6)
// + err, the bias's s + rho + g (6), and affine's s_ii + s_i1 + t_i +
// g_i (6) = 45.
constexpr int kMaxSums = 45;

// Illumination models: kIllum of the evaluation templates below.
constexpr int kIllumNone = 0;
constexpr int kIllumBias = 1;
constexpr int kIllumAffine = 2;

// Tent-tap sample of the frozen window at grid pixel (i, j), displacement
// (du, dv) from the window centre.  The TPU kernels sweep all (2r+1)^2
// taps; a tent weight max(0, 1 - |d - k|) is non-zero for at most two k
// per axis (floor(d) and floor(d) + 1), so only those <= 4 taps are read,
// straight from the parity planes, and summed in the sweep's order: rows
// ascending, and within a row by column parity plane first (stride 2),
// then by column.  Taps outside [-r, r] carry no weight in the sweep and
// are skipped; a NaN displacement gives NaN as it does there.
__device__ __forceinline__ float tent_sample(
    const float* __restrict__ planes, int s, int ph, int pw, int r,
    int i, int j, float du, float dv) {
  if (isnan(du) || isnan(dv)) return nanf("");
  const float fy = floorf(dv);
  const float fx = floorf(du);
  const float rf = (float)r;
  float acc = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 2; ++ty) {
    const float kyf = fy + (float)ty;
    if (!(kyf >= -rf && kyf <= rf)) continue;
    const float wy = fmaxf(0.0f, 1.0f - fabsf(dv - kyf));
    const int a = r + (int)kyf;
    const float* prow = planes + (size_t)((a % s) * s) * ph * pw
                        + (size_t)(a / s + i) * pw;
    // Column taps fx (first) and fx + 1 (second); at stride 2 the sweep
    // visits the even-parity plane before the odd one.
    float term[2];
    bool have[2];
#pragma unroll
    for (int tx = 0; tx < 2; ++tx) {
      const float kxf = fx + (float)tx;
      have[tx] = kxf >= -rf && kxf <= rf;
      term[tx] = 0.0f;
      if (have[tx]) {
        const float wx = fmaxf(0.0f, 1.0f - fabsf(du - kxf));
        const int b = r + (int)kxf;
        const float val = prow[(size_t)((b % s)) * ph * pw + b / s + j];
        term[tx] = (wy * wx) * val;
      }
    }
    const bool swap = (s == 2) && have[0] && ((r + (int)fx) % 2 == 1);
    if (swap) {
      if (have[1]) acc = acc + term[1];
      acc = acc + term[0];
    } else {
      if (have[0]) acc = acc + term[0];
      if (have[1]) acc = acc + term[1];
    }
  }
  return acc;
}

// Block-wide sums of N per-thread partials.  Every thread holds the totals
// in v after the call; the order of the sum is fixed by the launch shape,
// so a run repeats bit for bit.  `red` is (kWarps + 1) * kMaxSums floats of
// shared memory.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  static_assert(N <= kMaxSums, "too many sums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * kMaxSums + k] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float x = lane < kWarps ? red[lane * kMaxSums + k] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[kWarps * kMaxSums + k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = red[kWarps * kMaxSums + k];
  __syncthreads();
}

// Residuals of one element are kept between passes in a global scratch row
// with NaN marking invalid pixels (a valid residual is always finite: the
// window and template are finite).  Under "bias" the stored residual is
// raw and each pass subtracts the mean `mu` on the fly; under "affine" the
// kernel rewrites the row with the pre-fitted residual once, so the passes
// read it as it is (kBias false).

// Scale fixed point of the t-distribution weights: `unroll` block-wide
// passes over the stored residuals, each re-centred by `mu` when kBias.
// Returns the final lambda.
template <bool kBias>
__device__ __forceinline__ float t_scale(
    const float* __restrict__ res, int npx, float mu, float lam,
    float dof, int unroll, bool normalize, float count_safe, float* red) {
  for (int it = 0; it < unroll; ++it) {
    float part = 0.0f;
    for (int p = threadIdx.x; p < npx; p += kThreads) {
      float r = res[p];
      if (isnan(r)) continue;
      if constexpr (kBias) r = r - mu;
      const float rsq = r * r;
      const float w_est = (dof + 1.0f) / (dof + rsq * lam);
      part += rsq * w_est;
    }
    float tot[1] = {part};
    block_sum(tot, red);
    float sigma_sq = tot[0];
    if (normalize) sigma_sq = sigma_sq / count_safe;
    lam = 1.0f / fmaxf(sigma_sq, 1e-20f);
  }
  return lam;
}

// The weighted normal-equation sums over the stored residuals, in
// out[0..kSums<kIllum>): H upper triangle row-major [0, 21), sum(w J r)
// [21, 27), sum(w r^2) at 27; with bias or affine sum(w) at 28, sum(w r)
// at 29 and sum(w J) [30, 36); with affine, for the centred template
// t = gray - tpl_mu, sum(w t t) at 36, sum(w t) at 37, sum(w t r) at 38
// and sum(w J t) [39, 45).
template <int kIllum>
constexpr int kSums = kIllum == kIllumAffine ? 45 : kIllum == kIllumBias ? 36 : 28;

template <int kIllum>
__device__ __forceinline__ void reduce_system(
    const float* __restrict__ res, const float* __restrict__ jac,
    const float* __restrict__ gray, float tpl_mu, int npx, float mu,
    bool tweights, float lam, float dof, float (&acc)[kSums<kIllum>],
    float* red) {
#pragma unroll
  for (int k = 0; k < kSums<kIllum>; ++k) acc[k] = 0.0f;
  for (int p = threadIdx.x; p < npx; p += kThreads) {
    float r = res[p];
    if (isnan(r)) continue;
    if constexpr (kIllum == kIllumBias) r = r - mu;
    const float rsq = r * r;
    const float w = tweights ? (dof + 1.0f) / (dof + rsq * lam) : 1.0f;
    float j[6], jw[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      j[c] = jac[(size_t)c * npx + p];
      jw[c] = j[c] * w;
    }
#pragma unroll
    for (int a = 0, k = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b, ++k) acc[k] += jw[a] * j[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += jw[a] * r;
    acc[27] += w * rsq;
    if constexpr (kIllum != kIllumNone) {
      acc[28] += w;
      acc[29] += w * r;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[30 + a] += jw[a];
    }
    if constexpr (kIllum == kIllumAffine) {
      const float t = gray[p] - tpl_mu;
      const float wt = w * t;
      acc[36] += wt * t;
      acc[37] += wt;
      acc[38] += wt * r;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[39 + a] += jw[a] * t;
    }
  }
  block_sum(acc, red);
}

}  // namespace dvo
