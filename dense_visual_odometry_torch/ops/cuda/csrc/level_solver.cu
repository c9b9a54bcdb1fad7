// One pyramid level's whole Levenberg-Marquardt solve, one batch element
// over a thread-block cluster.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/level_solver.py:268
// _level_kernel (single frozen-window centre, illumination none, "bias" or
// "affine"; no row blocks, tiles, depth term or motion prior).
//
// Geometry.  Element b runs on cluster b of C CTAs (C in {1, 2, 4, 8, 16},
// chosen by level_solver.py's level_geometry from the batch and the level's
// size); CTA rank k owns the band of template rows
// [k * H' / C, (k + 1) * H' / C).  The band's residuals live in shared
// memory for the whole launch (the warp pass writes them; the affine
// pre-fit, the `unroll` t-scale passes and the normal equations read them),
// so no residual row goes through device memory.  When the band's points
// (3 planes), template (1) and Jacobian (6) fit beside its residuals in the
// block's shared memory ("resident"), they are copied in once per launch
// with cp.async; otherwise ("streamed") they are read from device memory
// once per LM iteration.  The frozen window is read through L1/L2 at <= 4
// tent taps per pixel.  Each thread takes several pixels per trip, their
// loads issued before use.
//
// Sums.  Each per-pixel term is formed in float32 as the plain version
// forms it, then added in float64 and the total rounded once to float32.
// The float64 error of a level's sum (< 1e-11 relative) is far below a
// float32 rounding step, so the totals are the same in any order: the
// kernel agrees bit for bit with lm_level_plain, which sums in float64 too,
// on the card and on the CPU, except where a float64 total falls within
// that error of a float32 rounding boundary.  Without it, a pose one bit
// off moves a template pixel across a validity edge (the ball, the image
// bounds) now and then, and the two runs part.  The order is still fixed,
// so a run repeats bit for bit: each thread over its pixels in ascending
// order, warp shuffles, the CTA's warps in ascending order, then the
// cluster's ranks in ascending order through distributed shared memory.
// Every rank adds up the same partials in the same order and so holds the
// same totals.
//
// The LM step (accept or reject, damping, 6x6 Cholesky, stopping rules,
// SE(3) update) runs on one thread of rank 0, which publishes the trial
// pose, the scale and the loop state; the other ranks read them from its
// shared memory.
//
// What bounds it on an H100: at the main path's sizes, latency, not bytes
// or operations.  Per LM iteration an element does 5-6 cluster-wide
// reductions (warp pass, affine pre-fit, `unroll` t-scale steps, normal
// equations), each a CTA barrier, a cluster barrier and remote reads, and
// the serial LM step on one thread, then the publish barrier: about 16 us
// an iteration with 640 pixels per CTA (level 3), about 30 us with 4,800
// resident pixels (level 0).  Streamed bands (B=64 at level 0, 38,400
// pixels per CTA) read the Jacobian, points and template from device
// memory every iteration: about 150 us an iteration.  The float64 sums
// cost about a fifth of the time (PERF.md).
#include <cooperative_groups.h>
#include <float.h>
#include <stdint.h>

#include "dvo_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPixPerTrip = 4;  // pixels a thread loads before it computes
constexpr int kMaxCluster = 16;  // largest cluster the launch may ask for
// Upper bound of the static shared memory below; level_solver.py adds it
// to the dynamic bytes when it sizes a geometry (STATIC_SHARED_BYTES).
constexpr int kStaticSharedBytes = 8192;

struct LevelParams {
  const float* planes;  // (B, s*s, ph, pw)
  const float* points;  // (B, 3, hp, wp), NaN where the depth is invalid
  const float* gray;    // (B, hp, wp)
  const float* jac;     // (B, 6, hp, wp)
  const float* scal;    // (B, in_cols) scalar row, layout below
  float* out;           // (B, 48) result row, layout below
  int ph, pw, hp, wp, in_cols, radius, image_h, image_w;
  int unroll, max_iterations, use_tweights, normalize_scale;
  int band_stride;      // floats per resident plane in shared memory
  float dof, tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max;
};
// scal: [0:16) est0 | [16:32) anchor0 | 32 wlam0 | 33 fx | 34 fy | 35 cx
//       | 36 cy | 37 cu | 38 cv | 39 relative tolerance (< 0 = off)
// out:  [0:16) est | [16:32) anchor | 32 wlam | 33 lm_lambda | 34 err
//       | 35 count | 36 iterations | 37.. zero

// Poses are the 12 entries (R | t) of the top three rows, row-major.
__device__ void se3_exp(const float d[6], float o[12]) {
  const float ux = d[0], uy = d[1], uz = d[2], wx = d[3], wy = d[4], wz = d[5];
  const float th_sq = wx * wx + wy * wy + wz * wz;
  const bool small = th_sq < (float)1e-4;
  const float th_safe = sqrtf(small ? 1.0f : th_sq);
  const float sin_t = sinf(th_safe);
  const float cos_t = cosf(th_safe);
  const float a = small ? 1.0f - th_sq / 6.0f + th_sq * th_sq / 120.0f
                        : sin_t / th_safe;
  const float b = small ? 0.5f - th_sq / 24.0f + th_sq * th_sq / 720.0f
                        : (1.0f - cos_t) / (small ? 1.0f : th_sq);
  const float c = small ? (float)(1.0 / 6.0) - th_sq / 120.0f + th_sq * th_sq / 5040.0f
                        : (th_safe - sin_t) / (small ? 1.0f : th_sq * th_safe);
  const float kxx = -(wy * wy + wz * wz), kyy = -(wx * wx + wz * wz),
              kzz = -(wx * wx + wy * wy);
  const float kxy = wx * wy, kxz = wx * wz, kyz = wy * wz;
  const float r00 = 1.0f + b * kxx, r11 = 1.0f + b * kyy, r22 = 1.0f + b * kzz;
  const float r01 = -a * wz + b * kxy, r10 = a * wz + b * kxy;
  const float r02 = a * wy + b * kxz, r20 = -a * wy + b * kxz;
  const float r12 = -a * wx + b * kyz, r21 = a * wx + b * kyz;
  const float v00 = 1.0f + c * kxx, v11 = 1.0f + c * kyy, v22 = 1.0f + c * kzz;
  const float v01 = -b * wz + c * kxy, v10 = b * wz + c * kxy;
  const float v02 = b * wy + c * kxz, v20 = -b * wy + c * kxz;
  const float v12 = -b * wx + c * kyz, v21 = b * wx + c * kyz;
  o[0] = r00; o[1] = r01; o[2] = r02; o[3] = v00 * ux + v01 * uy + v02 * uz;
  o[4] = r10; o[5] = r11; o[6] = r12; o[7] = v10 * ux + v11 * uy + v12 * uz;
  o[8] = r20; o[9] = r21; o[10] = r22; o[11] = v20 * ux + v21 * uy + v22 * uz;
}

__device__ void compose(const float a[12], const float b[12], float o[12]) {
  for (int r = 0; r < 3; ++r) {
    const float* ar = a + 4 * r;
    for (int c = 0; c < 3; ++c)
      o[4 * r + c] = ar[0] * b[c] + ar[1] * b[4 + c] + ar[2] * b[8 + c];
    o[4 * r + 3] = ar[0] * b[3] + ar[1] * b[7] + ar[2] * b[11] + ar[3];
  }
}

__device__ void inverse(const float m[12], float o[12]) {
  o[0] = m[0]; o[1] = m[4]; o[2] = m[8];
  o[3] = -(m[0] * m[3] + m[4] * m[7] + m[8] * m[11]);
  o[4] = m[1]; o[5] = m[5]; o[6] = m[9];
  o[7] = -(m[1] * m[3] + m[5] * m[7] + m[9] * m[11]);
  o[8] = m[2]; o[9] = m[6]; o[10] = m[10];
  o[11] = -(m[2] * m[3] + m[6] * m[7] + m[10] * m[11]);
}

__device__ __forceinline__ int upper(int i, int j) {  // packed index, i <= j
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Damped 6x6 solve by an unrolled Cholesky factorisation (h: upper
// triangle, row-major packing), as the Pallas kernel's _chol_solve6.
__device__ void chol_solve6(const float h[21], const float rhs[6], float x[6]) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = h[upper(j, j)];
    for (int t = 0; t < j; ++t) s = s - L[j][t] * L[j][t];
    const float djj = sqrtf(fmaxf(s, 1e-30f));
    L[j][j] = djj;
    const float inv = 1.0f / djj;
    for (int i = j + 1; i < 6; ++i) {
      float si = h[upper(j, i)];
      for (int t = 0; t < j; ++t) si = si - L[i][t] * L[j][t];
      L[i][j] = si * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
    for (int t = 0; t < i; ++t) s = s - L[i][t] * y[t];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int t = i + 1; t < 6; ++t) s = s - L[t][i] * x[t];
    x[i] = s / L[i][i];
  }
}

// What every rank needs of the LM state to run the next evaluation.
struct Published {
  float est_try[12];
  float wlam;
  int it, done;
};

struct LmState {
  Published pub;
  float lm_lam, err_acc, count_acc;
  float est_acc[12], anchor_acc[12], anchor_try[12];
  float hess_acc[21], rhs_acc[6];
};

// One LM step on the evaluation at pub.est_try (one thread of rank 0):
// accept or reject, adapt the damping, solve, test the stopping rules and
// move the trial point; _lm_loop's semantics with a per-element exit.
__device__ void lm_step(LmState& st, const LevelParams& P, float rel,
                        const float h21[21], const float rhs[6], float err,
                        float count, float lam) {
  const bool ok_eval = isfinite(err) && count >= 6.0f;
  const bool take = (err < st.err_acc) && ok_eval;
  if (take) {
    for (int k = 0; k < 12; ++k) {
      st.est_acc[k] = st.pub.est_try[k];
      st.anchor_acc[k] = st.anchor_try[k];
    }
    for (int k = 0; k < 21; ++k) st.hess_acc[k] = h21[k];
    for (int k = 0; k < 6; ++k) st.rhs_acc[k] = rhs[k];
    st.err_acc = err;
    st.count_acc = count;
  }
  float lm = take ? st.lm_lam * P.lm_down : st.lm_lam * P.lm_up;
  lm = fminf(fmaxf(lm, (float)1e-10), P.lm_lambda_max);

  const float* H = st.hess_acc;
  const float trace = H[0] + H[6] + H[11] + H[15] + H[18] + H[20];
  const float floor_ = (float)1e-8 * (1.0f + trace);
  float damped[21];
  for (int i = 0, k = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j, ++k)
      damped[k] = i == j ? H[k] + (lm * H[k] + floor_) : H[k] + 0.0f;
  float delta[6];
  chol_solve6(damped, st.rhs_acc, delta);
  bool okd = true;
  for (int k = 0; k < 6; ++k) okd = okd && isfinite(delta[k]);
  const bool ok = okd && st.count_acc >= 6.0f;
  for (int k = 0; k < 6; ++k) delta[k] = ok ? delta[k] : 0.0f;

  float pred = delta[0] * st.rhs_acc[0];
  for (int k = 1; k < 6; ++k) pred = pred + delta[k] * st.rhs_acc[k];
  pred = pred / fmaxf(st.count_acc, 1.0f);
  const bool converged =
      pred < P.tolerance || (rel >= 0.0f && pred < rel * fabsf(st.err_acc));
  const bool done2 = st.pub.done || (converged && ok_eval) || !ok ||
                     lm >= P.lm_lambda_max;

  float inc[12], inc_inv[12], tmp[12];
  se3_exp(delta, inc);
  inverse(inc, inc_inv);
  if (converged && ok_eval && ok) {
    compose(inc, st.est_acc, tmp);
    for (int k = 0; k < 12; ++k) st.est_acc[k] = tmp[k];
    compose(inc_inv, st.anchor_acc, tmp);
    for (int k = 0; k < 12; ++k) st.anchor_acc[k] = tmp[k];
  }
  if (!done2) {
    compose(inc, st.est_acc, st.pub.est_try);
    compose(inc_inv, st.anchor_acc, st.anchor_try);
  } else {
    for (int k = 0; k < 12; ++k) {
      st.pub.est_try[k] = st.est_acc[k];
      st.anchor_try[k] = st.anchor_acc[k];
    }
  }
  st.lm_lam = lm;
  st.pub.wlam = lam;
  st.pub.done = done2;
  st.pub.it += 1;
}

// The static shared memory of a CTA.
struct CtaShared {
  double warp[dvo::kWarps][dvo::kMaxSums];  // each warp's partials
  double part[2][dvo::kMaxSums];  // the CTA's partials, read by every rank
  double tot[dvo::kMaxSums];      // the cluster's totals
  Published view;                // this rank's copy of rank 0's pub
  LmState st;                    // rank 0 only
};
static_assert(sizeof(CtaShared) <= kStaticSharedBytes, "raise kStaticSharedBytes");

// Cluster-wide float64 sums of N per-thread partials, rounded to float32
// into out; every thread of every rank holds the same totals afterwards.
// `phase` alternates the CTA's partial buffer, so a rank still reading the
// previous reduction's partials of a slower rank never sees them
// overwritten: a rank writes a buffer again only after the next cluster
// barrier, which every rank reaches only once it has read the buffer.
template <int N>
__device__ __forceinline__ void cluster_sum(const double (&v)[N], float (&out)[N], CtaShared& sh,
                                            int& phase, const cg::cluster_group& cl, int nrank) {
  static_assert(N <= dvo::kMaxSums, "too many sums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sh.warp[warp][k] = x;
  }
  __syncthreads();
  double* part = sh.part[phase];
  if (threadIdx.x < N) {
    double x = sh.warp[0][threadIdx.x];
    for (int w = 1; w < dvo::kWarps; ++w) x += sh.warp[w][threadIdx.x];
    part[threadIdx.x] = x;
  }
  cl.sync();
  if (threadIdx.x < N) {
    // All remote loads first, then the sum in rank order.
    double p[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      p[r] = r < nrank ? *cl.map_shared_rank(part + threadIdx.x, r) : 0.0;
    double x = p[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < nrank) x += p[r];
    sh.tot[threadIdx.x] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = (float)sh.tot[k];
  phase ^= 1;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Issue the copy of n floats into shared memory (dst 16-byte aligned): in
// 16-byte pieces when the source is aligned too, else float by float.
__device__ __forceinline__ void copy_band(float* dst, const float* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int q = threadIdx.x; q < n4; q += dvo::kThreads) cp_async16(dst + 4 * q, src + 4 * q);
    done = 4 * n4;
  }
  for (int p = done + threadIdx.x; p < n; p += dvo::kThreads) cp_async4(dst + p, src + p);
}

template <int kIllum, int S, bool kResident>
__global__ void __launch_bounds__(dvo::kThreads, 1) level_kernel(LevelParams P) {
  constexpr bool kAffine = kIllum == dvo::kIllumAffine;
  const cg::cluster_group cl = cg::this_cluster();
  const int nrank = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / nrank;
  const int npx = P.hp * P.wp;
  const int row0 = rank * P.hp / nrank;
  const int off = row0 * P.wp;                           // band's first pixel
  const int n = ((rank + 1) * P.hp / nrank - row0) * P.wp;  // band's pixels
  const float* planes = P.planes + (size_t)b * S * S * P.ph * P.pw;
  const float* scal = P.scal + (size_t)b * P.in_cols;

  __shared__ CtaShared sh;
  extern __shared__ __align__(16) float dyn[];
  float* res = dyn;
  // The band's inputs: copies in shared memory, or device memory.
  const float *ptx, *pty, *ptz, *gray, *jac;
  int jst;  // stride between Jacobian planes
  {
    const float* g_pts = P.points + (size_t)b * 3 * npx + off;
    const float* g_gray = P.gray + (size_t)b * npx + off;
    const float* g_jac = P.jac + (size_t)b * 6 * npx + off;
    if constexpr (kResident) {
      // After the residuals: points (3), template, Jacobian (6), each a
      // plane of band_stride floats (RESIDENT_PLANES = 11 in all).
      const int st = P.band_stride;
      float* d = dyn + st;
      for (int c = 0; c < 3; ++c) copy_band(d + c * st, g_pts + (size_t)c * npx, n);
      copy_band(d + 3 * st, g_gray, n);
      for (int c = 0; c < 6; ++c) copy_band(d + (4 + c) * st, g_jac + (size_t)c * npx, n);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      ptx = d; pty = d + st; ptz = d + 2 * st; gray = d + 3 * st; jac = d + 4 * st;
      jst = st;
    } else {
      ptx = g_pts; pty = g_pts + npx; ptz = g_pts + 2 * npx; gray = g_gray; jac = g_jac;
      jst = npx;
    }
  }
  auto ld = [](const float* p) {
    if constexpr (kResident) return *p;
    else return __ldg(p);
  };

  const float fx = scal[33], fy = scal[34], cx = scal[35], cy = scal[36];
  const float cu = scal[37], cv = scal[38], rel = scal[39];
  const float rad = (float)P.radius;
  const float stride = (float)S;
  const float wmax = (float)(P.image_w - 1), hmax = (float)(P.image_h - 1);

  if (threadIdx.x == 0) {
    Published& v = rank == 0 ? sh.st.pub : sh.view;
    v.it = 0;
    v.done = 0;
    v.wlam = scal[32];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c) v.est_try[4 * r + c] = scal[4 * r + c];
    if (rank == 0) {
      LmState& st = sh.st;
      st.lm_lam = P.lm_lambda0;
      st.err_acc = FLT_MAX;
      st.count_acc = 0.0f;
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 4; ++c) {
          st.est_acc[4 * r + c] = scal[4 * r + c];
          st.anchor_acc[4 * r + c] = st.anchor_try[4 * r + c] = scal[16 + 4 * r + c];
        }
      for (int k = 0; k < 21; ++k) st.hess_acc[k] = 0.0f;
      for (int k = 0; k < 6; ++k) st.rhs_acc[k] = 0.0f;
      sh.view = st.pub;
    }
  }
  if constexpr (kResident) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  int phase = 0;
  // Every rank holds the same view, so every rank runs the same trips.
  while (!sh.view.done && sh.view.it < P.max_iterations) {
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = sh.view.est_try[k];

    // Warp, mask and sample; residuals to shared memory (NaN = invalid).
    double part[kAffine ? 3 : 2] = {};  // count, sum of residuals (, template)
    for (int base = threadIdx.x; base < n; base += kPixPerTrip * dvo::kThreads) {
      float X[kPixPerTrip], Y[kPixPerTrip], Z[kPixPerTrip], G[kPixPerTrip];
#pragma unroll
      for (int k = 0; k < kPixPerTrip; ++k) {
        const int p = base + k * dvo::kThreads;
        const bool in = p < n;
        X[k] = in ? ld(ptx + p) : nanf("");
        Y[k] = in ? ld(pty + p) : nanf("");
        Z[k] = in ? ld(ptz + p) : nanf("");
        G[k] = in ? ld(gray + p) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kPixPerTrip; ++k) {
        const int p = base + k * dvo::kThreads;
        if (p >= n) break;
        const int q = off + p;
        const int i = q / P.wp;
        const int j = q - i * P.wp;
        const float px = X[k], py = Y[k], pz = Z[k];
        const float xp = T[0] * px + T[1] * py + T[2] * pz + T[3];
        const float yp = T[4] * px + T[5] * py + T[6] * pz + T[7];
        const float zp = T[8] * px + T[9] * py + T[10] * pz + T[11];
        const bool in_front = zp > (float)1e-6;
        const float z_safe = in_front ? zp : 1.0f;
        const float u = (fx * xp + cx * zp) / z_safe;
        const float v = (fy * yp + cy * zp) / z_safe;
        const float du = u - ((float)j * stride + cu);
        const float dv = v - ((float)i * stride + cv);
        const bool in_ball = du > -rad && du < rad && dv > -rad && dv < rad;
        const float x0 = floorf(u), y0 = floorf(v);
        const bool in_bounds =
            x0 >= 0.0f && y0 >= 0.0f && x0 + 1.0f <= wmax && y0 + 1.0f <= hmax;
        float r = nanf("");
        if (in_ball && in_bounds && in_front) {
          r = dvo::tent_sample<S>(planes, P.ph, P.pw, P.radius, i, j, du, dv) - G[k];
          part[0] += 1.0;
          part[1] += (double)r;
          if constexpr (kAffine) part[2] += (double)G[k];
        }
        res[p] = r;
      }
    }
    float sums[kAffine ? 3 : 2];
    cluster_sum(part, sums, sh, phase, cl, nrank);
    const float count = sums[0];
    const float count_safe = fmaxf(count, 1.0f);
    const float mu = kIllum != dvo::kIllumNone ? sums[1] / count_safe : 0.0f;
    float tpl_mu = 0.0f;
    if constexpr (kAffine) {
      // Unweighted gain pre-fit of the centred residual against the
      // centred template, then the band rewritten with what it leaves
      // (each thread revisits only its own pixels).
      tpl_mu = sums[2] / count_safe;
      double fit_part[2] = {0.0, 0.0};  // sum(t r), sum(t t)
      for (int p = threadIdx.x; p < n; p += dvo::kThreads) {
        const float r = res[p];
        if (isnan(r)) continue;
        const float t = ld(gray + p) - tpl_mu;
        fit_part[0] += (double)(t * (r - mu));
        fit_part[1] += (double)(t * t);
      }
      float fit[2];
      cluster_sum(fit_part, fit, sh, phase, cl, nrank);
      const float alpha = fit[0] / fmaxf(fit[1], 1e-6f);
      for (int p = threadIdx.x; p < n; p += dvo::kThreads) {
        const float r = res[p];
        if (!isnan(r)) res[p] = (r - mu) - alpha * (ld(gray + p) - tpl_mu);
      }
    }
    // Under "bias" the stored residual is raw and each pass centres it;
    // under "affine" the band already holds the pre-fitted residual.
    constexpr bool kCentre = kIllum == dvo::kIllumBias;

    float lam = sh.view.wlam;
    if (P.use_tweights) {
      for (int it = 0; it < P.unroll; ++it) {
        double part_s[1] = {0.0};
        for (int p = threadIdx.x; p < n; p += dvo::kThreads) {
          float r = res[p];
          if (isnan(r)) continue;
          if constexpr (kCentre) r = r - mu;
          const float rsq = r * r;
          part_s[0] += (double)(rsq * dvo::t_weight(rsq, lam, P.dof));
        }
        float tot[1];
        cluster_sum(part_s, tot, sh, phase, cl, nrank);
        float sigma_sq = tot[0];
        if (P.normalize_scale) sigma_sq = sigma_sq / count_safe;
        lam = 1.0f / fmaxf(sigma_sq, 1e-20f);
      }
    }

    // Weighted normal equations over the band.
    double acc_part[dvo::kSums<kIllum>];
#pragma unroll
    for (int k = 0; k < dvo::kSums<kIllum>; ++k) acc_part[k] = 0.0;
    for (int base = threadIdx.x; base < n; base += 2 * dvo::kThreads) {
      float R[2], J[2][6], G2[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int p = base + k * dvo::kThreads;
        R[k] = p < n ? res[p] : nanf("");
        if (isnan(R[k])) continue;
#pragma unroll
        for (int c = 0; c < 6; ++c) J[k][c] = ld(jac + c * jst + p);
        G2[k] = kAffine ? ld(gray + p) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (isnan(R[k])) continue;
        float r = R[k];
        if constexpr (kCentre) r = r - mu;
        const float w = P.use_tweights ? dvo::t_weight(r * r, lam, P.dof) : 1.0f;
        dvo::accumulate_system<kIllum, double>(acc_part, r, w, J[k], G2[k] - tpl_mu);
      }
    }
    float acc[dvo::kSums<kIllum>];
    cluster_sum(acc_part, acc, sh, phase, cl, nrank);

    if (rank == 0 && threadIdx.x == 0) {
      float h21[21], rhs[6];
      for (int k = 0; k < 21; ++k) h21[k] = acc[k];
      for (int k = 0; k < 6; ++k) rhs[k] = -acc[21 + k];
      float err = acc[27] / count_safe;
      if constexpr (kAffine) {
        // Rank-2 Schur elimination of the gain + bias pair, with
        // S = [[s_ii, s_i1], [s_i1, s_11]], t = (t_i, t_1), G = (g_i, g_1).
        const float s_11 = acc[28], t_1 = acc[29];
        const float* g_1 = acc + 30;
        const float s_ii = acc[36], s_i1 = acc[37], t_i = acc[38];
        const float* g_i = acc + 39;
        const float det = fmaxf(s_ii * s_11 - s_i1 * s_i1, 1e-6f);
        const float beta_i = (s_11 * t_i - s_i1 * t_1) / det;
        const float beta_1 = (s_ii * t_1 - s_i1 * t_i) / det;
        float m_i[6], m_1[6];
        for (int k = 0; k < 6; ++k) {
          m_i[k] = (s_11 * g_i[k] - s_i1 * g_1[k]) / det;
          m_1[k] = (s_ii * g_1[k] - s_i1 * g_i[k]) / det;
        }
        for (int i = 0, k = 0; i < 6; ++i)
          for (int jj = i; jj < 6; ++jj, ++k)
            h21[k] = h21[k] - (g_i[i] * m_i[jj] + g_1[i] * m_1[jj]);
        for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] + g_i[k] * beta_i + g_1[k] * beta_1;
        err = err - (t_i * beta_i + t_1 * beta_1) / count_safe;
      } else if constexpr (kIllum == dvo::kIllumBias) {
        // Rank-1 Schur elimination of the exposure bias (before the
        // prior, which this kernel does not carry).
        const float s_safe = fmaxf(acc[28], 1e-6f);
        const float rho = acc[29];
        const float* g = acc + 30;
        for (int i = 0, k = 0; i < 6; ++i)
          for (int jj = i; jj < 6; ++jj, ++k) h21[k] = h21[k] - g[i] * g[jj] / s_safe;
        for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] + g[k] * rho / s_safe;
        err = err - rho * rho / s_safe / count_safe;
      }
      lm_step(sh.st, P, rel, h21, rhs, err, count, lam);
    }
    // Publish: every rank copies rank 0's state.  Rank 0 writes it again
    // only after the next iteration's first cluster barrier, which every
    // rank reaches after this copy.
    cl.sync();
    constexpr int kPubWords = sizeof(Published) / 4;
    if (threadIdx.x < kPubWords) {
      const int* src = reinterpret_cast<const int*>(cl.map_shared_rank(&sh.st.pub, 0));
      reinterpret_cast<int*>(&sh.view)[threadIdx.x] = src[threadIdx.x];
    }
    __syncthreads();
  }
  // Rank 0's shared memory stays until every rank has read it.
  cl.sync();

  if (rank == 0 && threadIdx.x == 0) {
    const LmState& st = sh.st;
    float* o = P.out + (size_t)b * 48;
    for (int k = 0; k < 48; ++k) o[k] = 0.0f;
    for (int k = 0; k < 12; ++k) {
      o[k] = st.est_acc[k];
      o[16 + k] = st.anchor_acc[k];
    }
    o[15] = 1.0f;
    o[31] = 1.0f;
    o[32] = st.pub.wlam;
    o[33] = st.lm_lam;
    o[34] = st.err_acc >= FLT_MAX ? FLT_MAX : st.err_acc;
    o[35] = st.count_acc;
    o[36] = (float)st.pub.it;
  }
}

using KernelFn = void (*)(LevelParams);

template <int kIllum, int S>
KernelFn pick_residency(int resident) {
  return resident ? level_kernel<kIllum, S, true> : level_kernel<kIllum, S, false>;
}

template <int kIllum>
KernelFn pick_stride(int s, int resident) {
  return s == 2 ? pick_residency<kIllum, 2>(resident) : pick_residency<kIllum, 1>(resident);
}

// illum: 0 none, 1 bias, 2 affine (dvo::kIllum*); s: 1 or 2.
KernelFn pick(int illum, int s, int resident) {
  if (illum == dvo::kIllumAffine) return pick_stride<dvo::kIllumAffine>(s, resident);
  if (illum == dvo::kIllumBias) return pick_stride<dvo::kIllumBias>(s, resident);
  return pick_stride<dvo::kIllumNone>(s, resident);
}

// The launch shape of `batch` clusters of `cluster` CTAs; attrs must
// outlive cfg.
cudaError_t configure(KernelFn kern, int batch, int cluster, int dynamic_bytes,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute (&attrs)[1]) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dynamic_bytes);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(batch * cluster, 1, 1);
  cfg.blockDim = dim3(dvo::kThreads, 1, 1);
  cfg.dynamicSmemBytes = dynamic_bytes;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of this variant and shape the card holds at once
// (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int dvo_level_max_active_clusters(int illum, int s, int resident, int cluster,
                                             int dynamic_bytes, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
  const KernelFn kern = pick(illum, s, resident);
  cudaError_t e = configure(kern, 1, cluster, dynamic_bytes, nullptr, cfg, attrs);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  return static_cast<int>(e);
}

extern "C" int dvo_level_solver(
    const float* planes, const float* points, const float* gray,
    const float* jac, const float* scal, float* out,
    int batch, int s, int ph, int pw, int hp, int wp, int in_cols,
    int radius, int image_h, int image_w, float dof, int unroll,
    int use_tweights, int normalize_scale, int illum, float tolerance,
    float lm_lambda0, float lm_up, float lm_down, float lm_lambda_max,
    int max_iterations, int cluster, int resident, int band_stride,
    int dynamic_bytes, void* stream) {
  LevelParams P{planes, points, gray, jac, scal, out,
                ph, pw, hp, wp, in_cols, radius, image_h, image_w,
                unroll, max_iterations, use_tweights, normalize_scale, band_stride,
                dof, tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
  const KernelFn kern = pick(illum, s, resident);
  cudaError_t e = configure(kern, batch, cluster, dynamic_bytes,
                            static_cast<cudaStream_t>(stream), cfg, attrs);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, P);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
