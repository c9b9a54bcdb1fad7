// One pyramid level's whole Levenberg-Marquardt solve, one block per batch
// element.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/level_solver.py:268
// _level_kernel (single frozen-window centre, illumination none, "bias" or
// "affine"; no row blocks, tiles, depth term or motion prior).
//
// What bounds it on an H100: per LM iteration the block streams the
// template points (3 planes), the template, the 6 Jacobian planes and a
// residual scratch row several times (one pass to warp and sample, `unroll`
// passes for the t-scale, one for the normal equations), separated by
// block-wide reductions and a serial 6x6 solve on one thread.  With one
// block per element a batch of B uses min(B, 132) SMs, so small batches are
// latency bound (B = 1 runs on one SM) and large ones are bound by those
// bytes, mostly served from L2.
//
// What the design does about it: the iteration never leaves the block, so
// one launch covers the level (the Pallas kernel's reason to exist carries
// over: no per-iteration launches or host round trips); the window is read
// at <= 4 taps per pixel straight from the parity planes instead of the
// TPU's 49 rolled-tap sweep; the reductions are warp shuffles.  Spreading an
// element over several blocks (clusters) is left for later work.
#include <float.h>

#include "dvo_common.cuh"

namespace {

struct LevelParams {
  const float* planes;  // (B, s*s, ph, pw)
  const float* points;  // (B, 3, hp, wp), NaN where the depth is invalid
  const float* gray;    // (B, hp, wp)
  const float* jac;     // (B, 6, hp, wp)
  const float* scal;    // (B, in_cols) scalar row, layout below
  float* out;           // (B, 48) result row, layout below
  float* scratch;       // (B, hp * wp) residuals between passes
  int s, ph, pw, hp, wp, in_cols, radius, image_h, image_w;
  int unroll, max_iterations, use_tweights, normalize_scale;
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

struct LmState {
  int it, done;
  float lm_lam, wlam, err_acc, count_acc;
  float est_acc[12], anchor_acc[12], est_try[12], anchor_try[12];
  float hess_acc[21], rhs_acc[6];
};

// One LM step on the evaluation at est_try (thread 0 only): accept or
// reject, adapt the damping, solve, test the stopping rules and move the
// trial point; _lm_loop's semantics with a per-element exit.
__device__ void lm_step(LmState& st, const LevelParams& P, float rel,
                        const float h21[21], const float rhs[6], float err,
                        float count, float lam) {
  const bool ok_eval = isfinite(err) && count >= 6.0f;
  const bool take = (err < st.err_acc) && ok_eval;
  if (take) {
    for (int k = 0; k < 12; ++k) {
      st.est_acc[k] = st.est_try[k];
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
  const bool done2 = st.done || (converged && ok_eval) || !ok ||
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
    compose(inc, st.est_acc, st.est_try);
    compose(inc_inv, st.anchor_acc, st.anchor_try);
  } else {
    for (int k = 0; k < 12; ++k) {
      st.est_try[k] = st.est_acc[k];
      st.anchor_try[k] = st.anchor_acc[k];
    }
  }
  st.lm_lam = lm;
  st.wlam = lam;
  st.done = done2;
  st.it += 1;
}

template <int kIllum>
__global__ void __launch_bounds__(dvo::kThreads) level_kernel(LevelParams P) {
  constexpr bool kAffine = kIllum == dvo::kIllumAffine;
  const int b = blockIdx.x;
  const int npx = P.hp * P.wp;
  const float* planes = P.planes + (size_t)b * P.s * P.s * P.ph * P.pw;
  const float* ptx = P.points + (size_t)b * 3 * npx;
  const float* pty = ptx + npx;
  const float* ptz = pty + npx;
  const float* gray = P.gray + (size_t)b * npx;
  const float* jac = P.jac + (size_t)b * 6 * npx;
  const float* scal = P.scal + (size_t)b * P.in_cols;
  float* res = P.scratch + (size_t)b * npx;

  __shared__ float red[(dvo::kWarps + 1) * dvo::kMaxSums];
  __shared__ LmState st;

  const float fx = scal[33], fy = scal[34], cx = scal[35], cy = scal[36];
  const float cu = scal[37], cv = scal[38], rel = scal[39];
  const float rad = (float)P.radius;
  const float stride = (float)P.s;
  const float wmax = (float)(P.image_w - 1), hmax = (float)(P.image_h - 1);

  if (threadIdx.x == 0) {
    st.it = 0;
    st.done = 0;
    st.lm_lam = P.lm_lambda0;
    st.wlam = scal[32];
    st.err_acc = FLT_MAX;
    st.count_acc = 0.0f;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 4; ++c) {
        st.est_acc[4 * r + c] = st.est_try[4 * r + c] = scal[4 * r + c];
        st.anchor_acc[4 * r + c] = st.anchor_try[4 * r + c] = scal[16 + 4 * r + c];
      }
    for (int k = 0; k < 21; ++k) st.hess_acc[k] = 0.0f;
    for (int k = 0; k < 6; ++k) st.rhs_acc[k] = 0.0f;
  }
  __syncthreads();

  while (!st.done && st.it < P.max_iterations) {
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = st.est_try[k];

    // Warp, mask and sample; residuals to scratch (NaN = invalid).
    float part[kAffine ? 3 : 2] = {};  // count, sum of residuals (, template)
    for (int p = threadIdx.x; p < npx; p += dvo::kThreads) {
      const int i = p / P.wp;
      const int j = p - i * P.wp;
      const float px = ptx[p], py = pty[p], pz = ptz[p];
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
        r = dvo::tent_sample(planes, P.s, P.ph, P.pw, P.radius, i, j, du, dv) - gray[p];
        part[0] += 1.0f;
        part[1] += r;
        if constexpr (kAffine) part[2] += gray[p];
      }
      res[p] = r;
    }
    dvo::block_sum(part, red);
    const float count = part[0];
    const float count_safe = fmaxf(count, 1.0f);
    const float mu = kIllum != dvo::kIllumNone ? part[1] / count_safe : 0.0f;
    float tpl_mu = 0.0f;
    if constexpr (kAffine) {
      // Unweighted gain pre-fit of the centred residual against the
      // centred template, then the row rewritten with what it leaves
      // (each thread revisits only its own pixels).
      tpl_mu = part[2] / count_safe;
      float fit[2] = {0.0f, 0.0f};  // sum(t r), sum(t t)
      for (int p = threadIdx.x; p < npx; p += dvo::kThreads) {
        const float r = res[p];
        if (isnan(r)) continue;
        const float t = gray[p] - tpl_mu;
        fit[0] += t * (r - mu);
        fit[1] += t * t;
      }
      dvo::block_sum(fit, red);
      const float alpha = fit[0] / fmaxf(fit[1], 1e-6f);
      for (int p = threadIdx.x; p < npx; p += dvo::kThreads) {
        const float r = res[p];
        if (!isnan(r)) res[p] = (r - mu) - alpha * (gray[p] - tpl_mu);
      }
    }

    float lam = st.wlam;
    if (P.use_tweights)
      lam = dvo::t_scale<kIllum == dvo::kIllumBias>(
          res, npx, mu, lam, P.dof, P.unroll, P.normalize_scale, count_safe, red);
    float acc[dvo::kSums<kIllum>];
    dvo::reduce_system<kIllum>(res, jac, gray, tpl_mu, npx, mu, P.use_tweights,
                               lam, P.dof, acc, red);

    if (threadIdx.x == 0) {
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
      lm_step(st, P, rel, h21, rhs, err, count, lam);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    float* o = P.out + (size_t)b * 48;
    for (int k = 0; k < 48; ++k) o[k] = 0.0f;
    for (int k = 0; k < 12; ++k) {
      o[k] = st.est_acc[k];
      o[16 + k] = st.anchor_acc[k];
    }
    o[15] = 1.0f;
    o[31] = 1.0f;
    o[32] = st.wlam;
    o[33] = st.lm_lam;
    o[34] = st.err_acc >= FLT_MAX ? FLT_MAX : st.err_acc;
    o[35] = st.count_acc;
    o[36] = (float)st.it;
  }
}

}  // namespace

extern "C" int dvo_level_solver(
    const float* planes, const float* points, const float* gray,
    const float* jac, const float* scal, float* out, float* scratch,
    int batch, int s, int ph, int pw, int hp, int wp, int in_cols,
    int radius, int image_h, int image_w, float dof, int unroll,
    int use_tweights, int normalize_scale, int illum, float tolerance,
    float lm_lambda0, float lm_up, float lm_down, float lm_lambda_max,
    int max_iterations, void* stream) {
  LevelParams P{planes, points, gray, jac, scal, out, scratch,
                s, ph, pw, hp, wp, in_cols, radius, image_h, image_w,
                unroll, max_iterations, use_tweights, normalize_scale,
                dof, tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // illum: 0 none, 1 bias, 2 affine (dvo::kIllum*).
  if (illum == dvo::kIllumAffine)
    level_kernel<dvo::kIllumAffine><<<batch, dvo::kThreads, 0, st>>>(P);
  else if (illum == dvo::kIllumBias)
    level_kernel<dvo::kIllumBias><<<batch, dvo::kThreads, 0, st>>>(P);
  else
    level_kernel<dvo::kIllumNone><<<batch, dvo::kThreads, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}
