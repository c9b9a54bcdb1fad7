// Device code shared by the level-solver, fused-evaluation and stack-warp
// kernels: the per-pixel pieces of one photometric evaluation.
//
// The level and fused kernels evaluate the same per-pixel photometric model
// over the strided template grid of one batch element, with the same code
// (cluster_eval.cuh): warp the template points, sample the frozen window
// around the integer centre (cu, cv) by its tent taps (the level kernel may
// cut the grid into row blocks or tiles, each with its own centre and
// window, and take an anisotropic ball), form the residual
// against the template, take out the illumination pre-fit ("bias": the
// valid mean; "affine", level kernel only: also the gain against the
// centred template), run the t-distribution scale fixed point and reduce
// the weighted 6x6 normal equations over a thread-block cluster; the level
// kernel may add the depth term (accumulate_depth, on a frozen window over
// the current depth) and the motion prior.  The level kernel runs that
// evaluation once per LM iteration and takes the LM step; the fused kernel
// runs it once.  The stack-warp kernel is tent_sample alone.
//
// Arithmetic follows the Pallas kernels operation for operation; the only
// intended difference is how the sums are taken (in float64, in a fixed
// order; cluster_eval.cuh).  Build without --use_fast_math and with
// -fmad=false: the solver relies on NaN-poisoned points failing every
// comparison and on IEEE floor, sqrt and division.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dvo {

constexpr int kThreads = 512;  // threads of a level- or fused-kernel CTA
constexpr int kWarps = kThreads / 32;
// Largest number of cluster-wide sums one reduction carries: H (21) + b
// (6) + err, the bias's s + rho + g (6), and affine's s_ii + s_i1 + t_i +
// g_i (6) = 45.
constexpr int kMaxSums = 45;

// Illumination models: kIllum of the evaluation templates.
constexpr int kIllumNone = 0;
constexpr int kIllumBias = 1;
constexpr int kIllumAffine = 2;

// Grid strides.  Strides 1 and 2 are compile-time template values (their
// parity plane and plane column are a mask and a shift); every stride >= 3
// shares one instantiation, kRuntimeStride, that reads the stride at run
// time and divides.
constexpr int kRuntimeStride = 0;

// The grid stride of a variant: S, or the runtime value s for kRuntimeStride.
template <int S>
__device__ __forceinline__ int grid_stride(int s) {
  static_assert(S == 1 || S == 2 || S == kRuntimeStride, "grid stride 1, 2 or runtime");
  if constexpr (S == kRuntimeStride) return s;
  else return S;
}

// Tent-tap sample of a frozen window at its grid pixel (i, j) (the pixel's
// place in its block's window), displacement (du, dv) from the window
// centre, at grid stride S (1 or 2, or kRuntimeStride with the stride in
// s_rt), with tap radii rx across and ry down.
// The TPU kernels sweep all (2 ry + 1)(2 rx + 1) taps; a tent weight
// max(0, 1 - |d - k|) is
// non-zero for at most two k per axis (floor(d) and floor(d) + 1), so only
// those <= 4 taps are read, straight from the parity planes through the
// read-only path, and summed in the sweep's order: rows ascending, and
// within a row by column parity plane first, then by column.  Of a row's
// two taps, at window columns b0 = rx + floor(du) and b0 + 1, the second
// comes first exactly when s >= 2 and b0 % s == s - 1 (its plane is 0, the
// first's is s - 1).
// Taps outside [-ry, ry] x [-rx, rx] carry no weight in the sweep and are
// skipped; a NaN displacement gives NaN as it does there.  A tap's window
// offset a = ry + ky (b = rx + kx) is >= 0: its parity plane is a % s and
// its plane row a / s, a mask and a shift when S is 1 or 2.  All four taps
// are loaded, from offsets clamped into the window, before any is used (a
// tap outside the ball's range is loaded but not added), so a thread's
// loads are in flight together.
template <int S>
__device__ __forceinline__ float tent_sample(
    const float* __restrict__ planes, int ph, int pw, int rx, int ry,
    int i, int j, float du, float dv, int s_rt = S) {
  static_assert(S == 1 || S == 2 || S == kRuntimeStride, "grid stride 1, 2 or runtime");
  constexpr int kShift = S == 2 ? 1 : 0;
  [[maybe_unused]] const int s = grid_stride<S>(s_rt);
  const float fy = floorf(dv);
  const float fx = floorf(du);
  const float rxf = (float)rx, ryf = (float)ry;
  const int plane = ph * pw;
  // Rows fy, fy + 1 and columns fx (first), fx + 1 (second): weight, whether
  // the tap lies in the window, and its window offset clamped into it.
  float wy[2], wx[2];
  bool hy[2], hx[2];
  int row[2], col[2], pb0 = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float kyf = fy + (float)t;
    const float kxf = fx + (float)t;
    hy[t] = kyf >= -ryf && kyf <= ryf;
    hx[t] = kxf >= -rxf && kxf <= rxf;
    wy[t] = fmaxf(0.0f, 1.0f - fabsf(dv - kyf));
    wx[t] = fmaxf(0.0f, 1.0f - fabsf(du - kxf));
    const int a = ry + min(max((int)kyf, -ry), ry);
    const int b = rx + min(max((int)kxf, -rx), rx);
    if constexpr (S == kRuntimeStride) {
      const int qa = a / s, qb = b / s;
      const int pa = a - qa * s, pb = b - qb * s;
      row[t] = pa * s * plane + (qa + i) * pw;
      col[t] = pb * plane + qb + j;
      if (t == 0) pb0 = pb;
    } else {
      row[t] = (a & (S - 1)) * S * plane + ((a >> kShift) + i) * pw;
      col[t] = (b & (S - 1)) * plane + (b >> kShift) + j;
    }
  }
  float val[2][2];
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int tx = 0; tx < 2; ++tx) val[ty][tx] = __ldg(planes + row[ty] + col[tx]);
  // The sweep visits column parity plane 0 before plane s - 1.  With hx[0]
  // the first tap's clamped offset is b0 itself.
  bool swap;
  if constexpr (S == kRuntimeStride) swap = s >= 2 && hx[0] && pb0 == s - 1;
  else swap = (S == 2) && hx[0] && ((rx + (int)fx) & 1);
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

// The depth term's sums (level kernel, kDepth): H_z upper triangle
// row-major [0, 21), sum(w J r) [21, 27), sum(w r^2) at 27 and the count
// at 28.
constexpr int kDepthSums = 29;

// One depth-valid pixel's terms of those sums, added to acc: the current
// depth z_meas tent-sampled at the warp, the warped point (xp, yp, zp) and
// the previous depth's gradients times the focal lengths (gzx, gzy).  The
// residual z_meas - zp takes a Huber weight (delta: the threshold in
// metres) and the Jacobian grad Z . J_w - [0, 0, 1, y', -x', 0], each term
// formed in float32 in the Pallas kernel's order.
template <class T>
__device__ __forceinline__ void accumulate_depth(T (&acc)[kDepthSums], float z_meas, float xp,
                                                 float yp, float zp, float gzx, float gzy,
                                                 float delta) {
  const float rz = z_meas - zp;
  const float rabs = sqrtf(fmaxf(rz * rz, 1e-20f));
  const float w = rabs <= delta ? 1.0f : delta / rabs;
  const float izz = 1.0f / zp;
  const float izz2 = izz * izz;
  float jz[6];
  jz[0] = gzx * izz;
  jz[1] = gzy * izz;
  jz[2] = -(gzx * xp + gzy * yp) * izz2 - 1.0f;
  jz[3] = -gzx * xp * yp * izz2 - gzy * (1.0f + yp * yp * izz2) - yp;
  jz[4] = gzx * (1.0f + xp * xp * izz2) + gzy * xp * yp * izz2 + xp;
  jz[5] = -gzx * yp * izz + gzy * xp * izz;
  float jw[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) jw[c] = jz[c] * w;
#pragma unroll
  for (int a = 0, k = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b, ++k) acc[k] += T(jw[a] * jz[b]);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += T(jw[a] * rz);
  acc[27] += T(w * rz * rz);
  acc[28] += T(1);
}

}  // namespace dvo
