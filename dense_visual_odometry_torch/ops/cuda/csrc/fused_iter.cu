// One photometric evaluation of a pose reduced to its 6x6 system, one
// batch element over a thread-block cluster.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/fused_iter.py:56
// _fused_kernel, with the warp, masks and bias Schur of its wrapper
// fused_shift_iteration (:239): illumination none or "bias", every grid
// stride (1 and 2 at compile time, every stride >= 3 in one variant that
// reads it at run time, dvo::kRuntimeStride).
//
// It takes the level kernel's inputs (the frozen window, the NaN-poisoned
// template points, the template, the Jacobian planes and the scalar row,
// whose pose and t-scale lambda it evaluates) and runs the level kernel's
// evaluation once (cluster_eval.cuh): the warp of the template points,
// the ball, bounds and in-front masks, the tent taps, the bias centring,
// `unroll` t-scale steps warm-started from the row's lambda, and the
// weighted normal equations with the bias Schur, summed over the cluster
// in float64.  The band's residuals stay in shared memory.  Each input is
// read once, from device memory: points and template by the warp pass, the
// Jacobian by the normal-equation pass.  Reading everything once, the
// kernel prefers one wave of smaller clusters to two waves of larger ones
// (fused_iter.FUSED_KERNEL).  A copy of the Jacobian into shared memory,
// issued at the start to overlap the warp pass and the t-scale steps, was
// slower at B=8 and 64 on an H100 (PERF.md).
//
// What bounds it on an H100: at B <= 8, latency: one warp pass and 5
// dependent cluster reductions (count, 3 t-scale steps, normal equations),
// about 40 us at B=1 and 60 us at B=8.  At B=64 (2-CTA clusters, 38,400
// pixels per CTA) the bytes of the window taps, points, template and
// Jacobian set the bound (83 us); the kernel takes about 2.2x that: with
// one CTA of 16 warps per SM the warp pass issues too few loads and
// divisions at once to keep the memory busy, the t-scale steps leave it
// idle, and the float64 sums of the normal equations add a float-to-double
// conversion per term (PERF.md).
#include "cluster_eval.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOutCols = 48;

struct FusedParams {
  dvo::EvalInputs in;
  float* out;  // (B, 48): H 6x6 row-major | rhs 6 | err | count | lambda | zero
};

template <int kIllum, int S>
__global__ void __launch_bounds__(dvo::kThreads, 1) fused_kernel(FusedParams P) {
  const cg::cluster_group cl = cg::this_cluster();
  const int nrank = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / nrank;
  const float* scal = P.in.scal + (size_t)b * P.in.in_cols;

  __shared__ dvo::ClusterSums sums;
  extern __shared__ __align__(16) float dyn[];
  float* res = dyn;
  const dvo::Band band = dvo::band_of<S>(P.in, b, rank, nrank);

  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = __ldg(scal + k);
  int phase = 0;
  dvo::Evaluation<kIllum> ev;
  dvo::evaluate<kIllum, S, false>(P.in, band, T, __ldg(scal + 32), res, sums, phase, cl, nrank,
                                  ev);
  if (rank == 0 && threadIdx.x == 0) {
    float h21[21], rhs[6], err;
    dvo::reduced_system(ev, h21, rhs, err);
    float* o = P.out + (size_t)b * kOutCols;
    for (int i = 0, k = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j, ++k) {
        o[i * 6 + j] = h21[k];
        o[j * 6 + i] = h21[k];
      }
    for (int k = 0; k < 6; ++k) o[36 + k] = rhs[k];
    o[42] = err;
    o[43] = ev.count;
    o[44] = ev.lam;
    for (int k = 45; k < kOutCols; ++k) o[k] = 0.0f;
  }
  // Every rank's partials stay until every rank has read them.
  cl.sync();
}

using KernelFn = void (*)(FusedParams);

// Every stride has its variant; null for s < 1.
template <int kIllum>
KernelFn pick_stride(int s) {
  if (s == 1) return fused_kernel<kIllum, 1>;
  if (s == 2) return fused_kernel<kIllum, 2>;
  if (s >= 3) return fused_kernel<kIllum, dvo::kRuntimeStride>;
  return nullptr;
}

// illum: 0 none, 1 bias (dvo::kIllum*; no affine variant); s >= 1.  Null
// for any other combination.
KernelFn pick(int illum, int s) {
  if (illum == dvo::kIllumBias) return pick_stride<dvo::kIllumBias>(s);
  if (illum == dvo::kIllumNone) return pick_stride<dvo::kIllumNone>(s);
  return nullptr;
}

}  // namespace

// How many clusters of this variant and shape the card holds at once
// (cudaOccupancyMaxActiveClusters), in *out.  The level kernel's signature;
// this kernel keeps no inputs resident and has no depth term.
extern "C" int dvo_max_active_clusters(int illum, int s, int resident, int depth, int cluster,
                                       int dynamic_bytes, int* out) {
  const KernelFn kern = pick(illum, s);
  if (kern == nullptr || resident || depth) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dvo::max_active_clusters(kern, cluster, dynamic_bytes, out));
}

extern "C" int dvo_fused_evaluation(
    const float* planes, const float* points, const float* gray,
    const float* jac, const float* scal, float* out,
    int batch, int s, int ph, int pw, int hp, int wp, int in_cols,
    int radius, int image_h, int image_w, float dof, int unroll,
    int use_tweights, int normalize_scale, int illum, int cluster, int band_stride,
    int dynamic_bytes, void* stream) {
  const KernelFn kern = pick(illum, s);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // One window centre: the isotropic ball, one block of hp x wp pixels.
  const FusedParams P{
      {planes, points, gray, jac, scal, ph, pw, hp, wp, in_cols, radius, image_h, image_w,
       unroll, use_tweights, normalize_scale, band_stride, dof, nullptr, nullptr, 0.0f,
       radius, 1, hp, wp, 1, s},
      out};
  return static_cast<int>(dvo::launch(kern, P, batch, cluster, dynamic_bytes,
                                      static_cast<cudaStream_t>(stream)));
}
