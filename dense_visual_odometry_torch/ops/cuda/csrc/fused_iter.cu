// One fused photometric evaluation, one block per batch element.
//
// Replaces: dense_visual_odometry_tpu/ops/pallas/fused_iter.py:56
// _fused_kernel.
//
// What bounds it on an H100: the bytes of one pass over the frozen window
// taps, the displacements, validity, template and the 6 Jacobian planes,
// plus the residual scratch re-read by the t-scale and reduction passes;
// per pixel there are only a few dozen flops.  With one block per element
// a batch of B uses min(B, 132) SMs.
//
// What the design does about it: the same shared evaluation as the level
// kernel (dvo_common.cuh) -- <= 4 tent taps read straight from the parity
// planes, warp-shuffle block reductions -- and only the 56-float row of
// reduced scalars leaves the block.
#include "dvo_common.cuh"

namespace {

struct FusedParams {
  const float* planes;  // (B, s*s, ph, pw)
  const float* du;      // (B, hp, wp)
  const float* dv;      // (B, hp, wp)
  const float* gray;    // (B, hp, wp)
  const float* valid;   // (B, hp, wp) 0/1
  const float* jac;     // (B, 6, hp, wp)
  const float* lam0;    // (B,)
  float* out;           // (B, 56): H 36 | b 6 | err_sum | count | lambda
                        // | bias: s | rho | g 6 | zero
  float* scratch;       // (B, hp * wp)
  int s, ph, pw, hp, wp, radius, unroll, use_tweights, normalize_scale;
  float dof;
};

template <bool kBias>
__global__ void __launch_bounds__(dvo::kThreads) fused_kernel(FusedParams P) {
  const int b = blockIdx.x;
  const int npx = P.hp * P.wp;
  const size_t off = (size_t)b * npx;
  const float* planes = P.planes + (size_t)b * P.s * P.s * P.ph * P.pw;
  const float* jac = P.jac + (size_t)b * 6 * npx;
  float* res = P.scratch + off;
  __shared__ float red[(dvo::kWarps + 1) * dvo::kMaxSums];

  float part[2] = {0.0f, 0.0f};  // count, sum of residuals
  for (int p = threadIdx.x; p < npx; p += dvo::kThreads) {
    const float vf = P.valid[off + p];
    float r = nanf("");
    if (vf > 0.0f) {
      const int i = p / P.wp;
      const int j = p - i * P.wp;
      r = dvo::tent_sample(planes, P.s, P.ph, P.pw, P.radius, i, j,
                           P.du[off + p], P.dv[off + p]) - P.gray[off + p];
      part[1] += r;
    }
    part[0] += vf;
    res[p] = r;
  }
  dvo::block_sum(part, red);
  const float count = part[0];
  const float count_safe = fmaxf(count, 1.0f);
  const float mu = kBias ? part[1] / count_safe : 0.0f;

  float lam = P.lam0[b];
  if (P.use_tweights)
    lam = dvo::t_scale<kBias>(res, npx, mu, lam, P.dof, P.unroll,
                              P.normalize_scale, count_safe, red);
  constexpr int kIllum = kBias ? dvo::kIllumBias : dvo::kIllumNone;
  float acc[dvo::kSums<kIllum>];
  dvo::reduce_system<kIllum>(res, jac, nullptr, 0.0f, npx, mu, P.use_tweights,
                             lam, P.dof, acc, red);

  if (threadIdx.x == 0) {
    float* o = P.out + (size_t)b * 56;
    for (int i = 0, k = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j, ++k) {
        o[i * 6 + j] = acc[k];
        o[j * 6 + i] = acc[k];
      }
    for (int k = 0; k < 6; ++k) o[36 + k] = -acc[21 + k];
    o[42] = acc[27];
    o[43] = count;
    o[44] = lam;
    for (int k = 45; k < 56; ++k) o[k] = 0.0f;
    if constexpr (kBias) {
      o[45] = acc[28];
      o[46] = acc[29];
      for (int k = 0; k < 6; ++k) o[47 + k] = acc[30 + k];
    }
  }
}

}  // namespace

extern "C" int dvo_fused_iteration(
    const float* planes, const float* du, const float* dv, const float* gray,
    const float* valid, const float* jac, const float* lam0, float* out,
    float* scratch, int batch, int s, int ph, int pw, int hp, int wp,
    int radius, float dof, int unroll, int use_tweights, int normalize_scale,
    int illum_bias, void* stream) {
  FusedParams P{planes, du, dv, gray, valid, jac, lam0, out, scratch,
                s, ph, pw, hp, wp, radius, unroll, use_tweights,
                normalize_scale, dof};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (illum_bias)
    fused_kernel<true><<<batch, dvo::kThreads, 0, st>>>(P);
  else
    fused_kernel<false><<<batch, dvo::kThreads, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}
