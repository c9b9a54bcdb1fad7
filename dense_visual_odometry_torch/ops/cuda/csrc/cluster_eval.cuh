// One photometric evaluation of a batch element over a thread-block
// cluster, optionally with the depth term's sums: the device code of the
// level kernel (level_solver.cu, one evaluation per LM iteration) and the
// fused kernel (fused_iter.cu, one photometric evaluation per launch).
//
// Grid strides.  S = 1 and 2 are template values; every stride >= 3 runs
// the dvo::kRuntimeStride instantiation, which reads E.s and divides where
// the others mask and shift (tent_sample, dvo_common.cuh).
//
// Geometry.  Element b runs on cluster b of C CTAs (C in {1, 2, 4, 8, 16},
// chosen by level_solver.py's level_geometry from the batch, the level's
// size and the planes a kernel keeps in shared memory); CTA rank k owns the
// band of template rows [k * H' / C, (k + 1) * H' / C).  The band's
// residuals live in shared memory (the first plane of the dynamic shared
// memory): the warp pass writes them, the affine pre-fit, the `unroll`
// t-scale passes and the normal equations read them, so no residual row
// goes through device memory.  The level kernel copies the band's inputs
// into the planes after it with cp.async where they fit (stage_band); else,
// and in the fused kernel, they are read from device memory through the
// read-only path.  The frozen window is
// read through L1/L2 at <= 4 tent taps per pixel.  Each thread takes
// several pixels per trip of the warp pass, their loads issued before use.
// Row blocks and tiles (level kernel): the grid is cut into nby x nbx
// blocks of t_y x t_x pixels, each with its own centre and window; a pixel
// (i, j) takes block (i / t_y, j / t_x) and samples its window at
// (i mod t_y, j mod t_x) (window_at).  The level kernel keeps the centres
// in shared memory, after the band's planes, copied from the scalar row
// once per launch (block_centres).  The two passes over the pixels
// (warp_pass, depth_pass) take blocks as a compile-time flag that the
// level kernel picks at run time once per pass: without it (the fused
// kernel, and the level kernel on one centre) the code is the
// single-centre path, with no division and no register spent on blocks.
// The level kernel's depth variant (kDepth) adds a pass over the pixels the
// warp pass kept: the current depth's window at the same taps, the
// previous depth's gradients from device memory, 29 more float64 sums in
// the warp pass's reduction.
//
// Sums.  Each per-pixel term is formed in float32 as the plain version
// forms it, then added in float64 and the total rounded once to float32.
// The float64 error of a level's sum (< 1e-11 relative) is far below a
// float32 rounding step, so the totals are the same in any order: the
// kernels agree bit for bit with their plain versions, which sum in
// float64 too, on the card and on the CPU, except where a float64 total
// falls within that error of a float32 rounding boundary.  Without it, a
// pose one bit off moves a template pixel across a validity edge (the
// ball, the image bounds) now and then, and the two runs part.  The order
// is still fixed, so a run repeats bit for bit: each thread over its pixels
// in ascending order, warp shuffles, the CTA's warps in ascending order,
// then the cluster's ranks in ascending order through distributed shared
// memory.  Every rank adds up the same partials in the same order and so
// holds the same totals.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "dvo_common.cuh"

namespace dvo {

namespace cg = cooperative_groups;

constexpr int kPixPerTrip = 4;   // pixels a thread loads before it computes
constexpr int kMaxCluster = 16;  // largest cluster a launch may ask for
// Upper bound of a kernel's static shared memory; level_solver.py adds it
// to the dynamic bytes when it sizes a geometry (STATIC_SHARED_BYTES).
constexpr int kStaticSharedBytes = 8192;

// The inputs of an evaluation, in level_inputs' layout, and its constants.
struct EvalInputs {
  const float* planes;  // (B, nblk, s*s, ph, pw) frozen windows, one per block
  const float* points;  // (B, 3, hp, wp), NaN where the depth is invalid
  const float* gray;    // (B, hp, wp) template
  const float* jac;     // (B, 6, hp, wp) Jacobian planes
  const float* scal;    // (B, in_cols) scalar row, layout below
  int ph, pw, hp, wp, in_cols, radius, image_h, image_w;
  int unroll, use_tweights, normalize_scale;
  int band_stride;      // floats per band plane in shared memory
  float dof;
  // The depth term (level kernel, kDepth): the current depth's frozen
  // window at the same centres, (B, s*s, ph, pw), the previous depth's
  // gradients (B, 2, hp, wp) and the Huber threshold in metres.
  const float* zplanes = nullptr;
  const float* zgrad = nullptr;
  float depth_delta = 0.0f;
  // The ball's vertical tap radius (radius is the horizontal one) and the
  // blocks: nby x nbx blocks of t_y x t_x grid pixels, nblk = nby * nbx.
  int radius_y = 0;
  int nbx = 1, t_y = 0, t_x = 0, nblk = 1;
  // The grid stride, read by the kRuntimeStride variants (strides >= 3);
  // the others take it from their template argument.
  int s = 1;
};
// scal: [0:16) pose (row-major 4x4) | [16:32) anchor | 32 t-scale lambda
//       | 33 fx | 34 fy | 35 cx | 36 cy | 37 cu | 38 cv | 39 relative
//       tolerance (< 0 = off) | with nblk > 1: [40, 40 + nblk) each block's
//       cu, then each block's cv (37 and 38 unused); the fused kernel reads
//       [0:12), 32 and 33-38.

// A CTA's band: its pixels and where its inputs are read from.
struct Band {
  const float* planes;                        // the element's window planes
  const float* zplanes;                       // its depth window (kDepth)
  const float *ptx, *pty, *ptz, *gray, *jac;  // the band's first pixel
  const float* zgx;                           // its depth gradients (kDepth)
  int jst;                                    // floats between Jacobian planes
  int zst;                                    // floats between gradient planes
  int off, n;                                 // first pixel in the level, pixels
  float fx, fy, cx, cy, cu, cv;               // cu, cv: the one centre (nblk 1)
};

// The band of CTA `rank` of `nrank` of element b at grid stride S (or
// E.s, kRuntimeStride), its inputs in device memory.
template <int S>
__device__ __forceinline__ Band band_of(const EvalInputs& E, int b, int rank, int nrank) {
  const int s = grid_stride<S>(E.s);
  const int npx = E.hp * E.wp;
  const int row0 = rank * E.hp / nrank;
  Band B;
  B.off = row0 * E.wp;
  B.n = ((rank + 1) * E.hp / nrank - row0) * E.wp;
  B.planes = E.planes + (size_t)b * E.nblk * s * s * E.ph * E.pw;
  B.ptx = E.points + (size_t)b * 3 * npx + B.off;
  B.pty = B.ptx + npx;
  B.ptz = B.ptx + 2 * npx;
  B.gray = E.gray + (size_t)b * npx + B.off;
  B.jac = E.jac + (size_t)b * 6 * npx + B.off;
  B.jst = npx;
  B.zplanes = E.zplanes ? E.zplanes + (size_t)b * E.nblk * s * s * E.ph * E.pw : nullptr;
  B.zgx = E.zgrad ? E.zgrad + (size_t)b * 2 * npx + B.off : nullptr;
  B.zst = npx;
  const float* scal = E.scal + (size_t)b * E.in_cols;
  B.fx = scal[33]; B.fy = scal[34]; B.cx = scal[35]; B.cy = scal[36];
  B.cu = scal[37]; B.cv = scal[38];
  return B;
}

// Band planes the level kernel keeps in shared memory where they fit: the
// residuals, points (3), template, Jacobian (6); RESIDENT_PLANES in
// level_solver.py.
constexpr int kResidentPlanes = 11;

// The level kernel's copy of the block centres (each block's cu, then each
// block's cv) in dynamic shared memory, after the band's planes: all
// kResidentPlanes of them when kResident, else the residuals alone.  Taken
// from E where it is used, so that no register holds it through the LM
// loop.
template <bool kResident>
__device__ __forceinline__ float* block_centres(const EvalInputs& E) {
  extern __shared__ __align__(16) float dyn_shared[];
  return dyn_shared + (kResident ? kResidentPlanes : 1) * E.band_stride;
}

// Where grid pixel (i, j) samples: its block's window (an offset from the
// element's first window), its place in that window and its block's centre.
struct Window {
  int off, i, j;
  float cu, cv;
};

template <bool kBlocks, int S, bool kShared>
__device__ __forceinline__ Window window_at(const EvalInputs& E, const Band& B, int i, int j) {
  if constexpr (!kBlocks) {
    return Window{0, i, j, B.cu, B.cv};
  } else {
    const int k = i / E.t_y, l = j / E.t_x;
    const int t = k * E.nbx + l;
    const float* cen = block_centres<kShared>(E);
    const int s = grid_stride<S>(E.s);
    return Window{t * s * s * E.ph * E.pw, i - k * E.t_y, j - l * E.t_x, cen[t],
                  cen[E.nblk + t]};
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Wait for this thread's copies; a __syncthreads() after it makes every
// thread's copies visible to the CTA.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of n floats into shared memory (dst 16-byte aligned): in
// 16-byte pieces when the source is aligned too, else float by float.
__device__ __forceinline__ void copy_band(float* dst, const float* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int q = threadIdx.x; q < n4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q);
    done = 4 * n4;
  }
  for (int p = done + threadIdx.x; p < n; p += kThreads) cp_async4(dst + p, src + p);
}

// Issue the copies of the band's points, template and Jacobian into the
// shared planes at dst (`st` floats each, in that order) and point the band
// at them.  The caller waits (cp_async_wait_all, then __syncthreads) before
// they are read.
__device__ __forceinline__ void stage_band(Band& B, float* dst, int st) {
  copy_band(dst, B.ptx, B.n);
  copy_band(dst + st, B.pty, B.n);
  copy_band(dst + 2 * st, B.ptz, B.n);
  copy_band(dst + 3 * st, B.gray, B.n);
  B.ptx = dst; B.pty = dst + st; B.ptz = dst + 2 * st; B.gray = dst + 3 * st;
  dst += 4 * st;
  for (int c = 0; c < 6; ++c) copy_band(dst + c * st, B.jac + (size_t)c * B.jst, B.n);
  B.jac = dst;
  B.jst = st;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A plane of the band: a copy in shared memory, or device memory.
template <bool kShared>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// The cluster reduction's buffers, in a CTA's static shared memory.
struct ClusterSums {
  double warp[kWarps][kMaxSums];  // each warp's partials
  double part[2][kMaxSums];       // the CTA's partials, read by every rank
  double tot[kMaxSums];           // the cluster's totals
};

// Cluster-wide float64 sums of N per-thread partials, rounded to float32
// into out; every thread of every rank holds the same totals afterwards.
// `phase` alternates the CTA's partial buffer, so a rank still reading the
// previous reduction's partials of a slower rank never sees them
// overwritten: a rank writes a buffer again only after the next cluster
// barrier, which every rank reaches only once it has read the buffer.  A
// rank may exit only after a cluster barrier that follows its last sum.
template <int N>
__device__ __forceinline__ void cluster_sum(const double (&v)[N], float (&out)[N], ClusterSums& sh,
                                            int& phase, const cg::cluster_group& cl, int nrank) {
  static_assert(N <= kMaxSums, "too many sums");
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
    for (int w = 1; w < kWarps; ++w) x += sh.warp[w][threadIdx.x];
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

// An evaluation's cluster totals: the valid count, the t-scale lambda it
// ended with and accumulate_system's sums.
template <int kIllum>
struct Evaluation {
  float count, count_safe, lam;
  float acc[kSums<kIllum>];
};

// The warp pass of an evaluation over the band: warp the template points,
// mask and tent-sample, residuals to `res` (NaN = invalid), and this
// thread's partial sums to part (count, sum of residuals, and with affine
// the template's).  kBlocks: the pixel's row block or tile gives its window
// and centre, and the ball's vertical radius is radius_y; without it one
// centre and the isotropic ball, the code the fused kernel runs.
template <int kIllum, int S, bool kShared, bool kBlocks>
__device__ __forceinline__ void warp_pass(const EvalInputs& E, const Band& B,
                                          const float (&T)[12], float* res,
                                          double (&part)[kIllum == kIllumAffine ? 3 : 2]) {
  constexpr bool kAffine = kIllum == kIllumAffine;
  const int n = B.n;
  const int radius_y = kBlocks ? E.radius_y : E.radius;
  const float rad = (float)E.radius, rad_y = (float)radius_y;
  const float stride = (float)grid_stride<S>(E.s);
  const float wmax = (float)(E.image_w - 1), hmax = (float)(E.image_h - 1);
  // Template row and column of the thread's next pixel, stepped by
  // kThreads pixels at a time rather than divided out per pixel.
  const int step_row = kThreads / E.wp, step_col = kThreads % E.wp;
  int row = (B.off + threadIdx.x) / E.wp;
  int col = B.off + threadIdx.x - row * E.wp;
  for (int base = threadIdx.x; base < n; base += kPixPerTrip * kThreads) {
    float X[kPixPerTrip], Y[kPixPerTrip], Z[kPixPerTrip], G[kPixPerTrip];
#pragma unroll
    for (int k = 0; k < kPixPerTrip; ++k) {
      const int p = base + k * kThreads;
      const bool in = p < n;
      X[k] = in ? load<kShared>(B.ptx + p) : nanf("");
      Y[k] = in ? load<kShared>(B.pty + p) : nanf("");
      Z[k] = in ? load<kShared>(B.ptz + p) : nanf("");
      G[k] = in ? load<kShared>(B.gray + p) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPixPerTrip; ++k) {
      const int p = base + k * kThreads;
      if (p >= n) break;
      const int i = row, j = col;
      // The template pixel kThreads further on.
      row += step_row;
      col += step_col;
      if (col >= E.wp) {
        col -= E.wp;
        row += 1;
      }
      const float px = X[k], py = Y[k], pz = Z[k];
      const float xp = T[0] * px + T[1] * py + T[2] * pz + T[3];
      const float yp = T[4] * px + T[5] * py + T[6] * pz + T[7];
      const float zp = T[8] * px + T[9] * py + T[10] * pz + T[11];
      const bool in_front = zp > (float)1e-6;
      const float z_safe = in_front ? zp : 1.0f;
      const float u = (B.fx * xp + B.cx * zp) / z_safe;
      const float v = (B.fy * yp + B.cy * zp) / z_safe;
      const Window w = window_at<kBlocks, S, kShared>(E, B, i, j);
      const float du = u - ((float)j * stride + w.cu);
      const float dv = v - ((float)i * stride + w.cv);
      const bool in_ball = du > -rad && du < rad && dv > -rad_y && dv < rad_y;
      const float x0 = floorf(u), y0 = floorf(v);
      const bool in_bounds =
          x0 >= 0.0f && y0 >= 0.0f && x0 + 1.0f <= wmax && y0 + 1.0f <= hmax;
      float r = nanf("");
      if (in_ball && in_bounds && in_front) {
        r = tent_sample<S>(B.planes + w.off, E.ph, E.pw, E.radius, radius_y, w.i, w.j, du, dv,
                           E.s) -
            G[k];
        part[0] += 1.0;
        part[1] += (double)r;
        if constexpr (kAffine) part[2] += (double)G[k];
      }
      res[p] = r;
    }
  }
}

// The depth term's pass over the band (kDepth): on the pixels the warp pass
// kept (those whose residual this thread just wrote) whose sampled current
// depth is positive, the ball-limited validity of the Pallas kernel; this
// thread's partial sums to zpart.  A pass of its own, with the warp
// recomputed (the same operations, so the same values), keeps its 29
// accumulators out of the warp pass's registers.  kBlocks as warp_pass.
template <int S, bool kShared, bool kBlocks>
__device__ __forceinline__ void depth_pass(const EvalInputs& E, const Band& B,
                                           const float (&T)[12], const float* res,
                                           double (&zpart)[kDepthSums]) {
  const int n = B.n;
  const int radius_y = kBlocks ? E.radius_y : E.radius;
  const float stride = (float)grid_stride<S>(E.s);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    if (isnan(res[p])) continue;
    const int q = B.off + p;
    const int i = q / E.wp, j = q - i * E.wp;
    const float px = load<kShared>(B.ptx + p), py = load<kShared>(B.pty + p),
                pz = load<kShared>(B.ptz + p);
    const float xp = T[0] * px + T[1] * py + T[2] * pz + T[3];
    const float yp = T[4] * px + T[5] * py + T[6] * pz + T[7];
    const float zp = T[8] * px + T[9] * py + T[10] * pz + T[11];
    // In front: the warp pass's z_safe is zp.
    const float u = (B.fx * xp + B.cx * zp) / zp;
    const float v = (B.fy * yp + B.cy * zp) / zp;
    const Window w = window_at<kBlocks, S, kShared>(E, B, i, j);
    const float du = u - ((float)j * stride + w.cu);
    const float dv = v - ((float)i * stride + w.cv);
    const float z_meas = tent_sample<S>(B.zplanes + w.off, E.ph, E.pw, E.radius, radius_y,
                                        w.i, w.j, du, dv, E.s);
    if (!(z_meas > 0.0f)) continue;
    accumulate_depth<double>(zpart, z_meas, xp, yp, zp, __ldg(B.zgx + p) * B.fx,
                             __ldg(B.zgx + B.zst + p) * B.fy, E.depth_delta);
  }
}

// Evaluate the pose T (the 12 entries (R | t), row-major) with the t-scale
// warm-started at wlam: warp the band's template points, mask and sample,
// residuals to `res` (NaN = invalid); with kDepth, the depth term's sums
// (a second pass over the band); the illumination pre-fit (bias: the valid
// mean; affine: also the unweighted gain against the centred template);
// the `unroll` t-scale steps; the weighted normal equations.  The band's
// inputs are read from shared memory when kShared (stage_band, awaited),
// else from device memory.  Every thread of every rank calls it and holds
// the totals in ev; with kDepth the depth term's totals go to ztot
// (kDepthSums floats of the CTA's shared memory).  kMayBlock: E may hold
// row blocks or tiles (the level kernel); the two passes over the pixels
// then take their block path where E.nblk > 1, a branch taken once per
// pass, so that the single-centre path keeps its code and registers.
template <int kIllum, int S, bool kShared, bool kDepth = false, bool kMayBlock = false>
__device__ __forceinline__ void evaluate(const EvalInputs& E, const Band& B, const float (&T)[12],
                                         float wlam, float* res, ClusterSums& sh, int& phase,
                                         const cg::cluster_group& cl, int nrank,
                                         Evaluation<kIllum>& ev, float* ztot = nullptr) {
  constexpr bool kAffine = kIllum == kIllumAffine;
  constexpr int kPhoto = kAffine ? 3 : 2;  // the warp pass's photometric sums
  const int n = B.n;
  const bool blocks = kMayBlock && E.nblk > 1;

  double part[kPhoto] = {};  // count, sum of residuals (, template)
  if constexpr (kMayBlock) {
    if (blocks)
      warp_pass<kIllum, S, kShared, true>(E, B, T, res, part);
    else
      warp_pass<kIllum, S, kShared, false>(E, B, T, res, part);
  } else {
    warp_pass<kIllum, S, kShared, false>(E, B, T, res, part);
  }
  // The depth term's sums ride the warp pass's cluster reduction.
  constexpr int kWarpSums = kPhoto + (kDepth ? kDepthSums : 0);
  double all[kWarpSums];
#pragma unroll
  for (int k = 0; k < kPhoto; ++k) all[k] = part[k];
  if constexpr (kDepth) {
    double zpart[kDepthSums] = {};
    if constexpr (kMayBlock) {
      if (blocks)
        depth_pass<S, kShared, true>(E, B, T, res, zpart);
      else
        depth_pass<S, kShared, false>(E, B, T, res, zpart);
    } else {
      depth_pass<S, kShared, false>(E, B, T, res, zpart);
    }
#pragma unroll
    for (int k = 0; k < kDepthSums; ++k) all[kPhoto + k] = zpart[k];
  }
  float sums[kWarpSums];
  cluster_sum(all, sums, sh, phase, cl, nrank);
  if constexpr (kDepth) {
    // The totals stay in sh.tot until the next reduction's cluster barrier.
    if (threadIdx.x < kDepthSums) ztot[threadIdx.x] = (float)sh.tot[kPhoto + threadIdx.x];
  }
  ev.count = sums[0];
  ev.count_safe = fmaxf(ev.count, 1.0f);
  const float mu = kIllum != kIllumNone ? sums[1] / ev.count_safe : 0.0f;
  float tpl_mu = 0.0f;
  if constexpr (kAffine) {
    // Unweighted gain pre-fit of the centred residual against the centred
    // template, then the band rewritten with what it leaves (each thread
    // revisits only its own pixels).
    tpl_mu = sums[2] / ev.count_safe;
    double fit_part[2] = {0.0, 0.0};  // sum(t r), sum(t t)
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float r = res[p];
      if (isnan(r)) continue;
      const float t = load<kShared>(B.gray + p) - tpl_mu;
      fit_part[0] += (double)(t * (r - mu));
      fit_part[1] += (double)(t * t);
    }
    float fit[2];
    cluster_sum(fit_part, fit, sh, phase, cl, nrank);
    const float alpha = fit[0] / fmaxf(fit[1], 1e-6f);
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const float r = res[p];
      if (!isnan(r)) res[p] = (r - mu) - alpha * (load<kShared>(B.gray + p) - tpl_mu);
    }
  }
  // Under "bias" the stored residual is raw and each pass centres it;
  // under "affine" the band already holds the pre-fitted residual.
  constexpr bool kCentre = kIllum == kIllumBias;

  float lam = wlam;
  if (E.use_tweights) {
    for (int it = 0; it < E.unroll; ++it) {
      double part_s[1] = {0.0};
      for (int p = threadIdx.x; p < n; p += kThreads) {
        float r = res[p];
        if (isnan(r)) continue;
        if constexpr (kCentre) r = r - mu;
        const float rsq = r * r;
        part_s[0] += (double)(rsq * t_weight(rsq, lam, E.dof));
      }
      float tot[1];
      cluster_sum(part_s, tot, sh, phase, cl, nrank);
      float sigma_sq = tot[0];
      if (E.normalize_scale) sigma_sq = sigma_sq / ev.count_safe;
      lam = 1.0f / fmaxf(sigma_sq, 1e-20f);
    }
  }
  ev.lam = lam;

  // Weighted normal equations over the band.
  double acc_part[kSums<kIllum>];
#pragma unroll
  for (int k = 0; k < kSums<kIllum>; ++k) acc_part[k] = 0.0;
  for (int base = threadIdx.x; base < n; base += 2 * kThreads) {
    float R[2], J[2][6], G2[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = base + k * kThreads;
      R[k] = p < n ? res[p] : nanf("");
      if (isnan(R[k])) continue;
#pragma unroll
      for (int c = 0; c < 6; ++c) J[k][c] = load<kShared>(B.jac + c * B.jst + p);
      G2[k] = kAffine ? load<kShared>(B.gray + p) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (isnan(R[k])) continue;
      float r = R[k];
      if constexpr (kCentre) r = r - mu;
      const float w = E.use_tweights ? t_weight(r * r, lam, E.dof) : 1.0f;
      accumulate_system<kIllum, double>(acc_part, r, w, J[k], G2[k] - tpl_mu);
    }
  }
  cluster_sum(acc_part, ev.acc, sh, phase, cl, nrank);
}

// The reduced 6x6 system of an evaluation (one thread): H (upper triangle,
// row-major), rhs = -sum(w J r) and the mean error, with the illumination
// unknowns eliminated by their Schur complement (no depth term or prior:
// the level kernel adds them after it, in that order).
template <int kIllum>
__device__ __forceinline__ void reduced_system(const Evaluation<kIllum>& ev, float (&h21)[21],
                                               float (&rhs)[6], float& err) {
  const float* acc = ev.acc;
  const float count_safe = ev.count_safe;
  for (int k = 0; k < 21; ++k) h21[k] = acc[k];
  for (int k = 0; k < 6; ++k) rhs[k] = -acc[21 + k];
  err = acc[27] / count_safe;
  if constexpr (kIllum == kIllumAffine) {
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
  } else if constexpr (kIllum == kIllumBias) {
    // Rank-1 Schur elimination of the exposure bias (no motion prior).
    const float s_safe = fmaxf(acc[28], 1e-6f);
    const float rho = acc[29];
    const float* g = acc + 30;
    for (int i = 0, k = 0; i < 6; ++i)
      for (int jj = i; jj < 6; ++jj, ++k) h21[k] = h21[k] - g[i] * g[jj] / s_safe;
    for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] + g[k] * rho / s_safe;
    err = err - rho * rho / s_safe / count_safe;
  }
}

// The depth term's totals ztot (kDepthSums) added to a reduced system at
// weight dw: H += dw H_z, rhs -= dw sum(w J r), err += dw sum(w r^2) / count.
__device__ __forceinline__ void add_depth(const float* ztot, float dw, float (&h21)[21],
                                          float (&rhs)[6], float& err) {
  for (int k = 0; k < 21; ++k) h21[k] = h21[k] + dw * ztot[k];
  for (int k = 0; k < 6; ++k) rhs[k] = rhs[k] - dw * ztot[21 + k];
  err = err + dw * ztot[27] / fmaxf(ztot[28], 1.0f);
}

// The launch shape of `batch` clusters of `cluster` CTAs of kThreads
// threads; attrs must outlive cfg.
template <class Params>
cudaError_t configure(void (*kern)(Params), int batch, int cluster, int dynamic_bytes,
                      cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute (&attrs)[1]) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_bytes);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(batch * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

// How many clusters of `kern` at this shape the card holds at once
// (cudaOccupancyMaxActiveClusters), in *out.
template <class Params>
cudaError_t max_active_clusters(void (*kern)(Params), int cluster, int dynamic_bytes, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
  cudaError_t e = configure(kern, 1, cluster, dynamic_bytes, nullptr, cfg, attrs);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  return e;
}

// Launch `batch` clusters of `kern` on P.
template <class Params>
cudaError_t launch(void (*kern)(Params), const Params& P, int batch, int cluster,
                   int dynamic_bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[1];
  cudaError_t e = configure(kern, batch, cluster, dynamic_bytes, stream, cfg, attrs);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, P);
  if (e == cudaSuccess) e = cudaGetLastError();
  return e;
}

}  // namespace dvo
