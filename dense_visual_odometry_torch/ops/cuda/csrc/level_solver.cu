// One pyramid level's whole Levenberg-Marquardt solve, one batch element
// over a thread-block cluster.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/level_solver.py:268
// _level_kernel (one frozen-window centre, or one per row block or 2-D
// tile with an anisotropic ball; illumination none, "bias" or "affine";
// with or without the depth term and the motion prior; every grid stride:
// 1 and 2 as template values, every stride >= 3 in one variant that reads
// it at run time, dvo::kRuntimeStride).
//
// Row blocks and tiles are runtime parameters (nby, nbx, t_y, t_x,
// radius_y), not template variants: the warp pass and the depth pass take
// their block path or their single-centre path by one branch each (nblk >
// 1; cluster_eval.cuh, evaluate); on the block path a pixel finds its
// block's window and centre by two integer divisions (window_at).  Both
// paths are in every variant; the reductions and the LM step are shared.  The TPU kernel lays the
// blocks out as a mosaic with halo rows and columns that its uniform rolls
// may cross; here each block's window is its own array and no grid pixel
// is duplicated, so there is no halo pixel to mask.  The centres (2 floats
// a block) are copied from the scalar row into shared memory once per
// launch, after the band's planes.
//
// Each LM iteration is one evaluation of the trial pose over the cluster
// (cluster_eval.cuh: geometry, the band's residuals in shared memory, the
// float64 sums in a fixed order).  When the band's points (3 planes),
// template (1) and Jacobian (6) fit beside its residuals in the block's
// shared memory ("resident"), they are copied in once per launch with
// cp.async; otherwise ("streamed") they are read from device memory once
// per LM iteration.
//
// The depth term (kDepth, a variant of its own) samples the current
// depth's frozen window at the photometric taps and reads the previous
// depth's gradients from device memory, in a pass of its own over the
// band's valid pixels whose 29 sums ride the warp pass's cluster
// reduction (cluster_eval.cuh): no shared plane, cluster barrier or static
// shared byte more.  The motion prior is scalar algebra on the thread that
// takes the LM step: after the illumination Schur and the depth term,
// H += I/sigma, rhs += log(anchor)/sigma and its energy, at the trial
// anchor (se3_log; sigma and the energy form are launch parameters).
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
// cost about a fifth of the time (PERF.md).  The depth pass adds about
// 15 us an iteration to resident level-0 bands and 4-8 us at level 3;
// streamed, it reads the points again and doubles the iteration (PERF.md).
#include <float.h>

#include "cluster_eval.cuh"

namespace cg = cooperative_groups;

namespace {

struct LevelParams {
  dvo::EvalInputs in;
  float* out;  // (B, 48) result row, layout below
  int max_iterations;
  float tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max;
  float depth_weight;     // the depth term's weight (kDepth)
  int prior;              // the motion prior is on
  float inv_cov, sigma;   // 1/sigma and sigma, each rounded to float
  int reference_energy;   // the prior's energy: 0.5 sigma |log| (else 0.5 |log|^2 / sigma)
};
// in.scal: the pose is the starting estimate, [16:32) the starting anchor.
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

// se3 log of (R | t) -> (upsilon, phi): the plain twin's se3_log_rows
// (level_solver.py), operation for operation.  theta/2 = atan2(|v|, w) of
// the trace-pivot quaternion, where the Pallas kernel inverts sin by
// Newton steps; divisions by a constant are products with its float
// reciprocal, as there.
__device__ void se3_log(const float m[12], float o[6]) {
  const float tr = m[0] + m[5] + m[10];
  const float w = 0.5f * sqrtf(fmaxf(1.0f + tr, 1e-12f));
  const float inv4w = 1.0f / (4.0f * w);
  const float vx = (m[9] - m[6]) * inv4w;
  const float vy = (m[2] - m[8]) * inv4w;
  const float vz = (m[4] - m[1]) * inv4w;
  const float vn = sqrtf(vx * vx + vy * vy + vz * vz);
  const float theta = 2.0f * atan2f(vn, w);
  const bool small = vn < 1e-7f;
  const float scale = small ? 2.0f / fmaxf(w, 0.5f) : theta / vn;
  const float px = vx * scale, py = vy * scale, pz = vz * scale;
  const float t_sq = px * px + py * py + pz * pz;
  const bool small_d = t_sq < 1e-2f;
  const float t_sq_safe = small_d ? 1.0f : t_sq;
  const float t_safe = sqrtf(t_sq_safe);
  const float a = sinf(t_safe) / t_safe;
  const float b2 = (1.0f - cosf(t_safe)) / t_sq_safe;
  const float d = small_d ? (float)(1.0 / 12.0) + t_sq * (float)(1.0 / 720.0) +
                                t_sq * t_sq * (float)(31.0 / 60480.0)
                          : (1.0f - a / (2.0f * b2)) / t_sq_safe;
  const float tx = m[3], ty = m[7], tz = m[11];
  const float k1x = py * tz - pz * ty;
  const float k1y = pz * tx - px * tz;
  const float k1z = px * ty - py * tx;
  const float k2x = py * k1z - pz * k1y;
  const float k2y = pz * k1x - px * k1z;
  const float k2z = px * k1y - py * k1x;
  o[0] = tx - 0.5f * k1x + d * k2x;
  o[1] = ty - 0.5f * k1y + d * k2y;
  o[2] = tz - 0.5f * k1z + d * k2z;
  o[3] = px;
  o[4] = py;
  o[5] = pz;
}

// The motion prior toward `anchor` added to a reduced system, last:
// H += I/sigma, rhs += log(anchor)/sigma, err += its energy.
__device__ void add_prior(const LevelParams& P, const float anchor[12], float h21[21],
                          float rhs[6], float& err) {
  float lg[6];
  se3_log(anchor, lg);
  const int diag[6] = {0, 6, 11, 15, 18, 20};
  for (int k = 0; k < 6; ++k) h21[diag[k]] = h21[diag[k]] + P.inv_cov;
  for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] + P.inv_cov * lg[k];
  float sq = lg[0] * lg[0];
  for (int k = 1; k < 6; ++k) sq = sq + lg[k] * lg[k];
  err = P.reference_energy ? err + 0.5f * P.sigma * sqrtf(sq) : err + 0.5f * P.inv_cov * sq;
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
  dvo::ClusterSums sums;
  Published view;  // this rank's copy of rank 0's pub
  LmState st;      // rank 0 only
  float ztot[dvo::kDepthSums];  // the depth term's totals (kDepth)
};
static_assert(sizeof(CtaShared) <= dvo::kStaticSharedBytes, "raise kStaticSharedBytes");

template <int kIllum, int S, bool kResident, bool kDepth>
__global__ void __launch_bounds__(dvo::kThreads, 1) level_kernel(LevelParams P) {
  const cg::cluster_group cl = cg::this_cluster();
  const int nrank = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / nrank;
  const float* scal = P.in.scal + (size_t)b * P.in.in_cols;

  __shared__ CtaShared sh;
  extern __shared__ __align__(16) float dyn[];
  float* res = dyn;
  dvo::Band band = dvo::band_of<S>(P.in, b, rank, nrank);
  // After the residuals: points (3), template, Jacobian (6), each a plane
  // of band_stride floats (RESIDENT_PLANES = 11 in all); then, with blocks,
  // their centres.
  if constexpr (kResident)
    dvo::stage_band(band, dyn + P.in.band_stride, P.in.band_stride);
  if (P.in.nblk > 1) {  // read after the __syncthreads below
    float* cen = dvo::block_centres<kResident>(P.in);
    for (int t = threadIdx.x; t < 2 * P.in.nblk; t += dvo::kThreads) cen[t] = scal[40 + t];
  }
  const float rel = scal[39];

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
  if constexpr (kResident) dvo::cp_async_wait_all();
  __syncthreads();

  int phase = 0;
  // Every rank holds the same view, so every rank runs the same trips.
  while (!sh.view.done && sh.view.it < P.max_iterations) {
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = sh.view.est_try[k];
    dvo::Evaluation<kIllum> ev;
    dvo::evaluate<kIllum, S, kResident, kDepth, true>(P.in, band, T, sh.view.wlam, res, sh.sums,
                                                      phase, cl, nrank, ev, sh.ztot);
    if (rank == 0 && threadIdx.x == 0) {
      // The Pallas kernel's order: illumination Schur, depth term, prior.
      float h21[21], rhs[6], err;
      dvo::reduced_system(ev, h21, rhs, err);
      if constexpr (kDepth) dvo::add_depth(sh.ztot, P.depth_weight, h21, rhs, err);
      if (P.prior) add_prior(P, sh.st.anchor_try, h21, rhs, err);
      lm_step(sh.st, P, rel, h21, rhs, err, ev.count, ev.lam);
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

template <int kIllum, int S, bool kDepth>
KernelFn pick_residency(int resident) {
  return resident ? level_kernel<kIllum, S, true, kDepth> : level_kernel<kIllum, S, false, kDepth>;
}

// Every stride has its variant; null for s < 1.
template <int kIllum, bool kDepth>
KernelFn pick_stride(int s, int resident) {
  if (s == 1) return pick_residency<kIllum, 1, kDepth>(resident);
  if (s == 2) return pick_residency<kIllum, 2, kDepth>(resident);
  if (s >= 3) return pick_residency<kIllum, dvo::kRuntimeStride, kDepth>(resident);
  return nullptr;
}

template <bool kDepth>
KernelFn pick_illum(int illum, int s, int resident) {
  if (illum == dvo::kIllumAffine) return pick_stride<dvo::kIllumAffine, kDepth>(s, resident);
  if (illum == dvo::kIllumBias) return pick_stride<dvo::kIllumBias, kDepth>(s, resident);
  if (illum == dvo::kIllumNone) return pick_stride<dvo::kIllumNone, kDepth>(s, resident);
  return nullptr;
}

// illum: 0 none, 1 bias, 2 affine (dvo::kIllum*); s >= 1; depth: the
// variant with the depth term.  Null for any other combination.
KernelFn pick(int illum, int s, int resident, int depth) {
  return depth ? pick_illum<true>(illum, s, resident) : pick_illum<false>(illum, s, resident);
}

}  // namespace

// How many clusters of this variant and shape the card holds at once
// (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int dvo_max_active_clusters(int illum, int s, int resident, int depth, int cluster,
                                       int dynamic_bytes, int* out) {
  const KernelFn kern = pick(illum, s, resident, depth);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dvo::max_active_clusters(kern, cluster, dynamic_bytes, out));
}

// zplanes / zgrad: the depth term's inputs, null without it (depth 0).
// radius_y, nby, nbx, t_y, t_x: the ball's vertical radius and the blocks
// (1 x 1 blocks of hp x wp: one centre); ph, pw: one block's window.
extern "C" int dvo_level_solver(
    const float* planes, const float* points, const float* gray,
    const float* jac, const float* scal, const float* zplanes, const float* zgrad, float* out,
    int batch, int s, int ph, int pw, int hp, int wp, int in_cols,
    int radius, int image_h, int image_w, float dof, int unroll,
    int use_tweights, int normalize_scale, int illum, float tolerance,
    float lm_lambda0, float lm_up, float lm_down, float lm_lambda_max,
    int max_iterations, int depth, float depth_weight, float depth_delta,
    int prior, float inv_cov, float sigma, int reference_energy,
    int radius_y, int nby, int nbx, int t_y, int t_x,
    int cluster, int resident, int band_stride, int dynamic_bytes, void* stream) {
  const KernelFn kern = pick(illum, s, resident, depth);
  if (kern == nullptr || (depth && (zplanes == nullptr || zgrad == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nby < 1 || nbx < 1 || t_y < 1 || t_x < 1 || radius_y < 1 || radius_y > radius ||
      in_cols != 40 + (nby * nbx > 1 ? 2 * nby * nbx : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelParams P{
      {planes, points, gray, jac, scal, ph, pw, hp, wp, in_cols, radius, image_h, image_w,
       unroll, use_tweights, normalize_scale, band_stride, dof, depth ? zplanes : nullptr,
       depth ? zgrad : nullptr, depth_delta, radius_y, nbx, t_y, t_x, nby * nbx, s},
      out, max_iterations, tolerance, lm_lambda0, lm_up, lm_down, lm_lambda_max,
      depth_weight, prior, inv_cov, sigma, reference_energy};
  return static_cast<int>(dvo::launch(kern, P, batch, cluster, dynamic_bytes,
                                      static_cast<cudaStream_t>(stream)));
}
