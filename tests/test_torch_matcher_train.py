"""The port's LoFTR-lite training half against the JAX package's, on the CPU,
at 96x128 (a 192x256 bundled-format directory at ``--scale 0.5``), ``dim``
32, one layer, channels (8, 16), from the JAX init carried across
(``jax.random`` draws cannot be made in PyTorch).

- ``init_params``: the JAX keys, shapes, zeros, ones and temperatures, and
  each drawn tensor's scale (the port's values over its own generator's
  replayed normals against the JAX values over its key's normals).
- ``params_to_numpy`` inverts ``params_from_numpy`` bit for bit.
- ``coarse_gt_assignment`` / ``coarse_gt_with_targets`` equal the JAX
  package's bit for bit on rendered pairs (occlusions, pixels leaving the
  frame, a band without depth).
- ``matching_loss`` and ``fine_loss``: values within :data:`LOSS_RTOL`
  (1e-5), and each parameter's gradient within :data:`GRAD_RTOL` (5e-4) of
  that parameter's JAX gradient norm (measured: 2.2e-6 coarse, 6.7e-5 fine,
  the fine temperature's; the two packages sum the gather's backward and
  the softmax reductions in other orders).
- The clip tie: ``clip`` differentiates as ``jnp.clip`` and ``jnp.maximum``
  (0.5 at a bound); the loss's tail at probabilities of exactly 1.0 and
  1e-9 equals ``jax.grad``'s; the temperature at its bound 1e-3.
- The cosine rate equals optax's within :data:`RATE_ATOL` times the base
  rate at each of 805 steps (optax evaluates it in float32: measured 1.4e-7).
- Five Adam steps of the joint loss against ``optax.adam`` over the cosine
  decay: losses within :data:`STEP_LOSS_RTOL` (1e-5; measured 2.2e-6) and
  every parameter within :data:`STEP_PARAM_ATOL` (5e-6; measured 6.5e-7)
  after each step.
- The port's ``.npz`` read by the JAX ``load_params`` and its ``.pt`` by the
  JAX ``load_params_torch``, bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import bundled_dataset
from dense_visual_odometry_torch.apps import train_matcher as tt
from dense_visual_odometry_torch.io import synthetic as tsyn
from dense_visual_odometry_torch.models import matcher as tm
from dense_visual_odometry_tpu.models import matcher as jm

LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-4
RATE_ATOL = 4 * float(np.finfo(np.float32).eps)
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_ATOL = 5e-6
SIZE = dict(dim=32, layers=1, channels=(8, 16))
FINE_WEIGHT = 0.25
PAIRS = (0, 3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = bundled_dataset(tmp_path_factory.mktemp("bundled"), 192, 256, 4)
    return tt.build_dataset(tt.parse_args(["--data-dir", str(root), "--pairs", "4",
                                           "--holdout", "1"]))


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in jm.init_params(jax.random.key(0), **SIZE).items()}


@pytest.fixture(scope="module")
def jax_grads():
    """Both losses and their gradients, jitted once."""
    def both(p, g1, g2, gt, uvt):
        return (jax.value_and_grad(jm.matching_loss)(p, g1, g2, gt),
                jax.value_and_grad(jm.fine_loss)(p, g1, g2, gt, uvt))

    return jax.jit(both)


def pair(data, i, as_tensor):
    return [as_tensor(data[k][i]) for k in ("gray1", "gray2", "gt", "uv_target")]


def port_grads(params, data, i):
    """-> {loss: (value, JAX-layout gradients)} of the port at ``params``."""
    model = tm.LoFTRLite.from_numpy(params, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    g1, g2, gt, uvt = pair(data, i, torch.as_tensor)
    out = {}
    for name, loss in (("coarse", tm.matching_loss(model, g1, g2, gt)),
                       ("fine", tm.fine_loss(model, g1, g2, gt, uvt))):
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        named = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(model.named_parameters(), grads)}
        out[name] = (float(loss), tm.params_to_numpy(named))
    return out


def assert_grads_match(params, data, i, jax_grads):
    (cl, cg), (fl, fg) = jax_grads(params, *pair(data, i, jnp.asarray))
    port = port_grads(params, data, i)
    for name, value, grads in (("coarse", cl, cg), ("fine", fl, fg)):
        np.testing.assert_allclose(port[name][0], float(value), rtol=LOSS_RTOL)
        for key, want in grads.items():
            want = np.asarray(want)
            got = port[name][1][key]
            assert got.shape == want.shape
            scale = max(float(np.linalg.norm(want)), 1e-30)
            assert np.abs(got - want).max() <= GRAD_RTOL * scale, (name, key)


def test_init_params_keys_shapes_constants_scales(jax_params):
    port = tm.init_params(torch.Generator().manual_seed(7), **SIZE)
    assert list(port) == list(jax_params)
    replay = torch.Generator().manual_seed(7)
    jkeys = iter(jax.random.split(jax.random.key(0), 64))
    for key, want in jax_params.items():
        got = port[key]
        assert got.dtype == np.float32 and got.shape == want.shape, key
        if np.all(want == want.flat[0]):  # zeros, ones, temperatures
            np.testing.assert_array_equal(got, want)
            continue
        jax_scale = want / np.asarray(jax.random.normal(next(jkeys), want.shape, jnp.float32))
        port_scale = got / torch.randn(want.shape, generator=replay).numpy()
        np.testing.assert_allclose(port_scale, np.median(jax_scale), rtol=1e-6)
        np.testing.assert_allclose(jax_scale, np.median(jax_scale), rtol=1e-6)
    with pytest.raises(ValueError):
        tm.init_params(torch.Generator(), heads=2)


def test_params_round_trip(jax_params):
    model = tm.LoFTRLite.from_numpy(jax_params)
    back = tm.params_to_numpy(dict(model.named_parameters()))
    assert list(back) == list(jax_params)
    for k, v in jax_params.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coarse_labels_bit_for_bit(seed):
    gray, depth, k = tsyn.textured_scene(96, 128, seed=seed)
    depth = depth.copy()
    depth[:, :9] = 0.0  # cells without source depth
    rng = np.random.default_rng(seed)
    t = tt._random_se3(rng, 0.25, 0.3)  # large enough to leave the frame
    _, d2 = tsyn.render_view(gray, depth, k, t)
    d2[40:56, 60:80] = 0.0  # a hole in the target
    got = tm.coarse_gt_with_targets(depth, d2, k, t)
    want = jm.coarse_gt_with_targets(depth, d2, k, t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.coarse_gt_assignment(depth, d2, k, t, 0.02),
                                  jm.coarse_gt_assignment(depth, d2, k, t, 0.02))
    assert 0 < (got[0] >= 0).sum() < got[0].size


@pytest.mark.parametrize("i", PAIRS)
def test_losses_and_gradients_match_jax(data, jax_params, jax_grads, i):
    assert_grads_match(jax_params, data, i, jax_grads)


def test_clip_derivative_matches_jax():
    x = np.array([0.0, 1e-9, 0.5, 1.0, 2.0, 1e-3], np.float32)
    for lo, hi in ((1e-9, 1.0), (1e-3, None)):
        t = torch.tensor(x, requires_grad=True)
        y = tm.clip(t, lo) if hi is None else tm.clip(t, lo, hi)
        y.sum().backward()
        if hi is None:
            fn = lambda v: jnp.maximum(v, lo)  # noqa: E731
            np.testing.assert_array_equal(y.detach().numpy(), np.maximum(x, np.float32(lo)))
        else:
            fn = lambda v: jnp.clip(v, lo, hi)  # noqa: E731
            np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, lo, hi))
        want = np.asarray(jax.vmap(jax.grad(fn))(jnp.asarray(x)))
        np.testing.assert_array_equal(t.grad.numpy(), want)
    assert 0.5 in t.grad.numpy()


def test_loss_tail_at_a_clip_tie(monkeypatch):
    """Probabilities of exactly 1.0 (the dual softmax saturates at the
    trained temperature) and 1e-9: the gradient of ``matching_loss`` with
    respect to them is ``jax.grad``'s, half torch.clamp's at the ties."""
    rng = np.random.default_rng(0)
    p = rng.uniform(0.0, 0.5, (6, 6)).astype(np.float32)
    gt = np.array([0, 1, 2, -1, 4, 5], np.int32)
    p[0, 0], p[1, 1], p[2, 2] = 1.0, 1e-9, 0.0
    monkeypatch.setattr(jm, "coarse_similarity", lambda params, g1, g2: params["p"])
    jl, jg = jax.value_and_grad(jm.matching_loss)({"p": jnp.asarray(p)}, None, None,
                                                  jnp.asarray(gt))
    leaf = torch.tensor(p, requires_grad=True)
    stub = types.SimpleNamespace(similarity=lambda g1, g2: leaf)
    loss = tm.matching_loss(stub, None, None, torch.as_tensor(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(jg["p"]))
    assert leaf.grad[0, 0] == np.float32(-0.5 / 5)  # the tie at 1.0: half of -1 / P, 5 rows


def test_gradients_at_the_temperature_bound(data, jax_params, jax_grads):
    """Both temperatures at their bound 1e-3: ``jnp.maximum``'s tie halves
    their gradients."""
    params = {**jax_params, "temperature": np.float32(1e-3),
              "fine_temperature": np.float32(1e-3)}
    assert_grads_match(params, data, PAIRS[0], jax_grads)


def test_cosine_rate_matches_optax(jax_params):
    lr, steps = 1e-3, 800
    want = np.asarray(optax.cosine_decay_schedule(lr, steps)(jnp.arange(steps + 5)))
    opt, sched = tt.make_optimizer(tm.LoFTRLite.from_numpy(jax_params), lr, steps)
    got = []
    for _ in range(steps + 5):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(np.array(got), want, rtol=0, atol=RATE_ATOL * lr)
    assert got[-1] == 0.0 and got[0] == lr


def test_adam_steps_match_optax(data, jax_params):
    lr, steps = 1e-3, 800
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))
    dev = {k: jnp.asarray(v) for k, v in data.items()}

    def joint(p, g1, g2, gt, uvt):
        return jm.matching_loss(p, g1, g2, gt) + FINE_WEIGHT * jm.fine_loss(p, g1, g2, gt, uvt)

    @jax.jit
    def step(p, s, i):
        loss, g = jax.value_and_grad(joint)(p, dev["gray1"][i], dev["gray2"][i],
                                            dev["gt"][i], dev["uv_target"][i])
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    state = tx.init(jp)
    model = tm.LoFTRLite.from_numpy(jax_params)
    opt, sched = tt.make_optimizer(model, lr, steps)
    tdev = tt.upload(data, "cpu")
    for i in (0, 3, 1, 4, 2):
        jp, state, jl = step(jp, state, i)
        tl = tt.train_step(model, opt, sched, tdev, i, FINE_WEIGHT)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_LOSS_RTOL)
        got = tm.params_to_numpy(dict(model.named_parameters()))
        for k, v in jp.items():
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=STEP_PARAM_ATOL)


def test_files_read_by_jax(jax_params, tmp_path):
    params = tm.params_to_numpy(dict(tm.LoFTRLite.from_numpy(jax_params).named_parameters()))
    tm.save_params(tmp_path / "w" / "m.npz", params)
    tm.save_params_torch(tmp_path / "w" / "m.pt", params)
    jax_pt = tmp_path / "jax.pt"
    jm.save_params_torch(jax_pt, jax_params)
    for read in (jm.load_params(tmp_path / "w" / "m.npz"),
                 jm.load_params_torch(tmp_path / "w" / "m.pt"),
                 tm.load_params(tmp_path / "w" / "m.npz"),
                 tm.load_params(tmp_path / "w" / "m.pt")):
        assert set(read) == set(params)
        for k, v in params.items():
            got = np.asarray(read[k])
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, v)
    # The .pt holds what the JAX package's save_params_torch writes (its
    # 0-d temperatures as shape (1,) too).
    ours, theirs = (torch.load(p, weights_only=True) for p in (tmp_path / "w" / "m.pt", jax_pt))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape and torch.equal(ours[k], theirs[k]), k
    state = torch.load(tmp_path / "w" / "m.pt", weights_only=True)
    assert tuple(state["conv1_w"].shape) == (16, 8, 3, 3)  # OIHW
    assert tuple(state["l0_self_mlp1"].shape) == (32, 64)  # (in, out)
