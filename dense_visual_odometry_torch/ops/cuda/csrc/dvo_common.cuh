// Device code shared by the level-solver, fused-iteration and stack-warp
// kernels.
//
// The level and fused kernels evaluate the same per-pixel photometric model
// over the strided template grid of one batch element: sample the frozen
// window around the integer centre (cu, cv), form the residual against the
// template, take out the illumination pre-fit ("bias": the valid mean;
// "affine", level kernel only: also the gain against the centred
// template), run the t-distribution scale fixed point and reduce the
// weighted 6x6 normal equations.  The per-pixel pieces here are that
// evaluation; each kernel adds its own front end (the level kernel warps the
// template points itself, the fused kernel reads precomputed displacements),
// its own reductions (the level kernel over a thread-block cluster, the
// fused kernel over one block: block_sum below) and its own epilogue.  The
// stack-warp kernel is tent_sample alone.
//
// Arithmetic follows the Pallas kernels operation for operation; the only
// intended difference is how the sums are taken (the level kernel adds in
// float64, see level_solver.cu; the fused kernel in float32, in its own
// order).  Build without
// --use_fast_math and with -fmad=false: the solver relies on NaN-poisoned
// points failing every comparison and on IEEE floor, sqrt and division.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dvo {

constexpr int kThreads = 512;  // threads of a level- or fused-kernel block
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
// (du, dv) from the window centre, at grid stride S (1 or 2).  The TPU
// kernels sweep all (2r+1)^2 taps; a tent weight max(0, 1 - |d - k|) is
// non-zero for at most two k per axis (floor(d) and floor(d) + 1), so only
// those <= 4 taps are read, straight from the parity planes through the
// read-only path, and summed in the sweep's order: rows ascending, and
// within a row by column parity plane first (stride 2), then by column.
// Taps outside [-r, r] carry no weight in the sweep and are skipped; a NaN
// displacement gives NaN as it does there.  A tap's window offset a = r + k
// is >= 0, so with S known at compile time its parity plane and plane
// column are a mask and a shift.  All four taps are loaded, from offsets
// clamped into the window, before any is used (a tap outside [-r, r] is
// loaded but not added), so a thread's loads are in flight together.
template <int S>
__device__ __forceinline__ float tent_sample(
    const float* __restrict__ planes, int ph, int pw, int r,
    int i, int j, float du, float dv) {
  static_assert(S == 1 || S == 2, "grid stride 1 or 2");
  constexpr int kShift = S == 2 ? 1 : 0;
  const float fy = floorf(dv);
  const float fx = floorf(du);
  const float rf = (float)r;
  const int plane = ph * pw;
  // Rows fy, fy + 1 and columns fx (first), fx + 1 (second): weight, whether
  // the tap lies in the window, and its window offset clamped into it.
  float wy[2], wx[2];
  bool hy[2], hx[2];
  int row[2], col[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float kyf = fy + (float)t;
    const float kxf = fx + (float)t;
    hy[t] = kyf >= -rf && kyf <= rf;
    hx[t] = kxf >= -rf && kxf <= rf;
    wy[t] = fmaxf(0.0f, 1.0f - fabsf(dv - kyf));
    wx[t] = fmaxf(0.0f, 1.0f - fabsf(du - kxf));
    const int a = r + min(max((int)kyf, -r), r);
    const int b = r + min(max((int)kxf, -r), r);
    row[t] = (a & (S - 1)) * S * plane + ((a >> kShift) + i) * pw;
    col[t] = (b & (S - 1)) * plane + (b >> kShift) + j;
  }
  float val[2][2];
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int tx = 0; tx < 2; ++tx) val[ty][tx] = __ldg(planes + row[ty] + col[tx]);
  // At stride 2 the sweep visits the even-parity plane before the odd one.
  const bool swap = (S == 2) && hx[0] && ((r + (int)fx) & 1);
  float acc = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 2; ++ty) {
    if (!hy[ty]) continue;
    const float t0 = (wy[ty] * wx[0]) * val[ty][0];
    const float t1 = (wy[ty] * wx[1]) * val[ty][1];
    if (swap) {
      if (hx[1]) acc = acc + t1;
      acc = acc + t0;
    } else {
      if (hx[0]) acc = acc + t0;
      if (hx[1]) acc = acc + t1;
    }
  }
  return isnan(du) || isnan(dv) ? nanf("") : acc;
}

// The same sample at a stride known only at run time (the fused kernel).
__device__ __forceinline__ float tent_sample(
    const float* __restrict__ planes, int s, int ph, int pw, int r,
    int i, int j, float du, float dv) {
  return s == 2 ? tent_sample<2>(planes, ph, pw, r, i, j, du, dv)
                : tent_sample<1>(planes, ph, pw, r, i, j, du, dv);
}

// The t-distribution weight of a squared residual at scale lambda.
__device__ __forceinline__ float t_weight(float rsq, float lam, float dof) {
  return (dof + 1.0f) / (dof + rsq * lam);
}

// The weighted normal-equation sums, in acc[0..kSums<kIllum>): H upper
// triangle row-major [0, 21), sum(w J r) [21, 27), sum(w r^2) at 27; with
// bias or affine sum(w) at 28, sum(w r) at 29 and sum(w J) [30, 36); with
// affine, for the centred template t = gray - tpl_mu, sum(w t t) at 36,
// sum(w t) at 37, sum(w t r) at 38 and sum(w J t) [39, 45).
template <int kIllum>
constexpr int kSums = kIllum == kIllumAffine ? 45 : kIllum == kIllumBias ? 36 : 28;

// One valid pixel's terms of those sums, added to acc: residual r (centred
// by the caller), weight w, Jacobian row j, centred template t (affine).
// Each term is formed in float32; T is the type it is added in.
template <int kIllum, class T>
__device__ __forceinline__ void accumulate_system(
    T (&acc)[kSums<kIllum>], float r, float w, const float (&j)[6], float t) {
  const float rsq = r * r;
  float jw[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) jw[c] = j[c] * w;
#pragma unroll
  for (int a = 0, k = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b, ++k) acc[k] += T(jw[a] * j[b]);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += T(jw[a] * r);
  acc[27] += T(w * rsq);
  if constexpr (kIllum != kIllumNone) {
    acc[28] += T(w);
    acc[29] += T(w * r);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[30 + a] += T(jw[a]);
  }
  if constexpr (kIllum == kIllumAffine) {
    const float wt = w * t;
    acc[36] += T(wt * t);
    acc[37] += T(wt);
    acc[38] += T(wt * r);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[39 + a] += T(jw[a] * t);
  }
}

// ---------------------------------------------------------------------------
// One block per batch element (the fused kernel).
// ---------------------------------------------------------------------------

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
// window and template are finite); under "bias" the stored residual is raw
// and each pass subtracts the mean `mu` on the fly.

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
      part += rsq * t_weight(rsq, lam, dof);
    }
    float tot[1] = {part};
    block_sum(tot, red);
    float sigma_sq = tot[0];
    if (normalize) sigma_sq = sigma_sq / count_safe;
    lam = 1.0f / fmaxf(sigma_sq, 1e-20f);
  }
  return lam;
}

// The weighted normal-equation sums over the stored residuals; `gray` and
// `tpl_mu` are read under affine only.
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
    const float w = tweights ? t_weight(r * r, lam, dof) : 1.0f;
    float j[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) j[c] = jac[(size_t)c * npx + p];
    const float t = kIllum == kIllumAffine ? gray[p] - tpl_mu : 0.0f;
    accumulate_system<kIllum, float>(acc, r, w, j, t);
  }
  block_sum(acc, red);
}

}  // namespace dvo
