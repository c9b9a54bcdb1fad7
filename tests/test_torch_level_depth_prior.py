"""The level kernel's depth term and motion prior: the plain version against
the JAX package's Pallas kernel.

``lm_level`` on CPU tensors (the plain version, ``lm_level_plain``) against
``lm_level_pallas(..., interpret=True)``, as ``test_torch_kernels.py`` holds
the photometric variants: the same numpy arrays on both sides, a seeded
synthetic scene (smooth texture over bumpy depth) seen from a second pose,
B=2 on a 30x40 grid, grid strides 1 and 2, the solves starting from the
truth off by a seeded twist.

- The prior (``sigma``) in both energy forms, toward an anchor 0.02 rad and
  2 cm from the identity, so that its log is not trivial.
- The depth term (``depth_planes``: the current depth's frozen window at the
  same centres; ``zgrad``: the previous depth's Sobel gradients over the
  gain) under illumination none, "bias" and "affine", at the configuration's
  weight and Huber threshold.

Tolerances: transforms 1e-5 absolute; iteration counts identical; err,
count and the IRLS lambda 1e-4 relative.  Liveness, on the plain version
alone: a binding prior (sigma 1e-9) and a heavy depth term (weight 1e7)
each move the solve by more than 1e-6 from the term's absence, as the JAX
package's own tests require of its kernel.

``test_cuda_depth_prior_match_plain`` holds each new variant of the CUDA
kernel against the plain version on the card (B=1, 2 and 64) and skips
without one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.ops import gradients
from dense_visual_odometry_torch.ops.cuda import level_solver as tlevel
from dense_visual_odometry_torch.utils.lie import se3
from dense_visual_odometry_tpu.ops.pallas import level_solver as jlevel
from tests.test_torch_kernels import CFG, GRID_H, GRID_W, _kernel_kwargs

ANCHOR_XI = (0.02, -0.01, 0.015, 0.01, -0.02, 0.005)
PRIORS = {"consistent": (2e-7, False), "reference": (1e-4, True)}


def depth_case(stride: int, device="cpu", batch=2):
    """-> (args, kwargs of ``lm_level``, depth_planes, zgrad) of B pairs of a
    seeded scene, frozen at a start pose, anchored at ``ANCHOR_XI``."""
    h, w = GRID_H * stride, GRID_W * stride
    gray, depth, k = synthetic.textured_scene(h, w, seed=3)
    poses = synthetic.handheld_trajectory(3, seed=4, t_step=0.02, r_step=0.01)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    cam = CameraModel.create(k, 1.0)
    frames = [
        robust.preprocess_frame(g, d, cam, levels=1, device=device)
        for g, d in zip(grays, depths)
    ]
    pairs = ([(0, 1), (2, 1)] * batch)[:batch]
    prev_g = torch.stack([frames[i].gray[0] for i, _ in pairs])
    prev_d = torch.stack([frames[i].depth_m[0] for i, _ in pairs])
    curr_g = torch.stack([frames[j].gray[0] for _, j in pairs])
    curr_d = torch.stack([frames[j].depth_m[0] for _, j in pairs])
    gt = torch.as_tensor(
        np.stack([np.linalg.inv(poses[j]) @ poses[i] for i, j in pairs]),
        dtype=torch.float32, device=device,
    )
    rng = np.random.default_rng(stride)
    xi = torch.as_tensor(rng.normal(0, 4e-3, (batch, 6)), dtype=torch.float32, device=device)
    est0 = se3.exp(xi) @ gt
    anchor0 = se3.exp(torch.tensor(ANCHOR_XI, device=device)).expand(batch, 4, 4)
    cfg = dataclasses.replace(CFG, grid_strides=(stride,))
    k_t = cam.at(0).to(device)
    fl = robust.prepare_level(prev_g, prev_d, curr_g, k_t, est0, cfg, 0, depth_curr=curr_d)
    gzx, gzy = gradients.sobel(prev_d)
    zgrad = torch.stack([gzx / 8.0, gzy / 8.0], dim=1)[..., ::stride, ::stride].contiguous()
    wlam0 = torch.full((batch,), 0.04, device=device)
    # The absolute tolerance alone: the prior's energy would stop a relative
    # test at once.
    points, scal = tlevel.level_inputs(fl.cu, fl.cv, fl.depth_prev_m, k_t, est0, anchor0, wlam0,
                                       None, stride)
    args = (fl.planes, points, fl.gray_prev, fl.jac_planes, scal)
    return cfg, args, fl.depth_planes, zgrad, (h, w)


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def case(request):
    return (request.param,) + depth_case(request.param)


def run_both(args, kw):
    """-> (port rows, JAX rows) of the same inputs; the port's must not
    launch a kernel (CPU tensors)."""
    before = tlevel.lm_level.launches
    out_t = tlevel.lm_level(*args, **kw).numpy()
    assert tlevel.lm_level.launches == before
    jkw = dict(kw)
    for name in ("depth_planes", "zgrad"):
        if jkw.get(name) is not None:
            jkw[name] = jnp.asarray(jkw[name].numpy())
    jkw["zgrad_planes"] = jkw.pop("zgrad", None)
    out_j = np.asarray(
        jlevel.lm_level_pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True, **jkw)
    )
    return out_t, out_j


def assert_rows_match(out_t, out_j):
    np.testing.assert_array_equal(out_t[:, 36], out_j[:, 36])
    assert out_t[:, 36].min() >= 2  # the LM loop really iterated
    np.testing.assert_allclose(out_t[:, 0:16], out_j[:, 0:16], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 16:32], out_j[:, 16:32], atol=1e-5)
    np.testing.assert_allclose(out_t[:, 32:36], out_j[:, 32:36], rtol=1e-4)
    np.testing.assert_array_equal(out_t[:, 37:], out_j[:, 37:])


@pytest.mark.parametrize("prior", list(PRIORS))
def test_level_solver_prior_matches_pallas(case, prior):
    stride, cfg, args, _, _, image_hw = case
    sigma, ref = PRIORS[prior]
    kw = dict(_kernel_kwargs(cfg, image_hw, None), sigma=sigma,
              reference_prior_energy=ref)
    assert_rows_match(*run_both(args, kw))


@pytest.mark.parametrize("illum", [None, "bias", "affine"], ids=["no_illum", "bias", "affine"])
def test_level_solver_depth_matches_pallas(case, illum):
    stride, cfg, args, depth_planes, zgrad, image_hw = case
    kw = dict(_kernel_kwargs(cfg, image_hw, illum), depth_planes=depth_planes,
              zgrad=zgrad, depth_weight=cfg.depth_weight,
              depth_huber_delta=cfg.depth_huber_delta)
    assert_rows_match(*run_both(args, kw))


@pytest.mark.parametrize("term", ["prior", "depth"])
def test_terms_bind(case, term):
    """A binding prior and a heavy depth term move the plain solve."""
    stride, cfg, args, depth_planes, zgrad, image_hw = case
    kw = _kernel_kwargs(cfg, image_hw, None)
    off = tlevel.lm_level(*args, **kw)
    if term == "prior":
        on = tlevel.lm_level(*args, **dict(kw, sigma=1e-9))
    else:
        on = tlevel.lm_level(*args, **dict(kw, depth_planes=depth_planes, zgrad=zgrad,
                                           depth_weight=1e7, depth_huber_delta=1e4))
    assert torch.isfinite(on).all()
    assert float((on[:, :12] - off[:, :12]).abs().max()) > 1e-6


def test_depth_inputs_come_together(case):
    stride, cfg, args, depth_planes, zgrad, image_hw = case
    kw = _kernel_kwargs(cfg, image_hw, None)
    with pytest.raises(ValueError, match="together"):
        tlevel.lm_level(*args, **kw, depth_planes=depth_planes)
    with pytest.raises(ValueError, match="zgrad has shape"):
        tlevel.lm_level(*args, **kw, depth_planes=depth_planes, zgrad=zgrad[:, :1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 64], ids=["b1", "b2", "b64"])
@pytest.mark.parametrize("variant", ["prior", "prior_reference", "depth", "depth_bias",
                                     "depth_affine", "depth_prior"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
def test_cuda_depth_prior_match_plain(stride, variant, batch):
    """Each new variant of the CUDA level kernel against the plain version
    on the card, same inputs: transforms 1e-5, iterations equal, err, count
    and lambda 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    cfg, args, depth_planes, zgrad, image_hw = depth_case(stride, device="cuda", batch=batch)
    illum = variant.split("_")[1] if variant in ("depth_bias", "depth_affine") else None
    kw = _kernel_kwargs(cfg, image_hw, illum)
    if variant.startswith("depth"):
        kw.update(depth_planes=depth_planes, zgrad=zgrad, depth_weight=cfg.depth_weight,
                  depth_huber_delta=cfg.depth_huber_delta)
    if "prior" in variant:
        sigma, ref = PRIORS["reference" if variant == "prior_reference" else "consistent"]
        kw.update(sigma=sigma, reference_prior_energy=ref)
    before = tlevel.lm_level.launches
    out_k = tlevel.lm_level(*args, **kw)
    assert tlevel.lm_level.launches == before + 1
    out_p = tlevel.lm_level_plain(*args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out_k[:, 36].cpu(), out_p[:, 36].cpu())
    np.testing.assert_allclose(out_k[:, :32].cpu(), out_p[:, :32].cpu(), atol=1e-5)
    np.testing.assert_allclose(out_k[:, 32:36].cpu(), out_p[:, 32:36].cpu(), rtol=1e-4)
