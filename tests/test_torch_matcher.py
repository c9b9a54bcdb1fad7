"""The port's LoFTR-lite matcher (serving half) against the JAX package's, on
the CPU, at 120x160 with the committed weights
(``dense_visual_odometry_tpu/weights/loftr_lite.npz``) unless stated.

- The stages fed the same inputs: the backbone's tokens with the sine
  encoding, each attention block, and the fine feature map, within
  :data:`ATOL` (1e-5).
- ``coarse_similarity``: the dual-softmax probabilities within
  :data:`P_ATOL` (5e-5, not 1e-5), with the same ``match_coarse``
  selection.  The committed temperature is 0.0063, so a logit is a cosine
  times 159: the two packages' 64-term dot products round a cosine a few
  float32 steps apart (XLA:CPU and PyTorch add in other orders), which is
  1e-4 in a logit of 159 and 1.2e-5 in a probability near 1, measured on
  the final features of one package fed to both; end to end 1.9e-5.
- ``refine_matches_fine`` and ``track_sparse_learned`` (``fine`` zncc,
  learned and auto) within 1e-5, with equal validity and success.
- A state-dict ``.pt`` written by the JAX package's ``save_params_torch``
  loads into the port and gives the same similarity, bit for bit, as the
  ``.npz``; unknown keys raise.
- Random parameters of another size (``init_params`` at dim 32, one layer,
  channels (8, 16)), and a 100x140 image whose third conv pads an odd size.
- A 5-frame ``SparseVO`` session with ``matcher="learned"`` replaying the
  JAX session's key chain: poses within 1e-5, equal success flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.models import matcher as tm
from dense_visual_odometry_tpu.models import matcher as jm
from tests.test_torch_sparse import (
    _assert_matches,
    _assert_result,
    jax_sampler,
    run_sessions,
    smooth_pair,
)

ATOL = 1e-5
P_ATOL = 5e-5


@pytest.fixture(scope="module")
def weights():
    """-> (JAX parameters, the port's model) from the committed file."""
    return jm.load_params(), tm.load_matcher(device="cpu")


@pytest.fixture(scope="module")
def pair():
    grays, depths, k, _ = smooth_pair(seed=0, frames=3)
    return grays, depths, k


def test_weights_are_read_by_path():
    assert tm.DEFAULT_WEIGHTS.resolve() == jm.DEFAULT_WEIGHTS.resolve()
    params = tm.load_params()
    assert set(params) == set(jm.load_params())
    model = tm.LoFTRLite.from_numpy(params)
    assert (model.layers, model.n_convs, model.has_fine_head) == (2, 3, True)
    assert tuple(model.conv1_w.shape) == (64, 32, 3, 3)  # OIHW
    np.testing.assert_array_equal(model.l0_self_mlp1.numpy(), params["l0_self_mlp1"].T)


def test_stages_match_jax(weights, pair):
    params, model = weights
    grays = pair[0]
    g1, g2 = jnp.asarray(grays[0]), jnp.asarray(grays[1])
    f1 = np.asarray(jax.jit(lambda p, g: jm._backbone(p, g, 3))(params, g1))
    f2 = np.asarray(jax.jit(lambda p, g: jm._backbone(p, g, 3))(params, g2))
    np.testing.assert_allclose(model._backbone(torch.tensor(grays[0])).numpy(), f1, atol=ATOL)
    np.testing.assert_allclose(tm._sine_pe(15, 20, 64).numpy(),
                               np.asarray(jm._sine_pe(15, 20, 64)), atol=1e-6)
    att = jax.jit(lambda p, x, c, pre: jm._attention(p, pre, x, c, jm.HEADS),
                  static_argnums=3)
    for prefix in ("l0_self", "l0_cross", "l1_self", "l1_cross"):
        want = np.asarray(att(params, jnp.asarray(f1), jnp.asarray(f2), prefix))
        got = model._attention(prefix, torch.tensor(f1), torch.tensor(f2))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=prefix)
    ff = np.asarray(jax.jit(jm._fine_features)(params, g1))
    np.testing.assert_allclose(model._fine_features(torch.tensor(grays[0])).numpy(), ff,
                               atol=ATOL)


@pytest.mark.parametrize("frames", [(0, 1), (0, 2), (2, 1)])
def test_coarse_similarity_and_selection_match_jax(weights, pair, frames):
    params, model = weights
    grays = pair[0]
    a, b = (grays[i] for i in frames)
    jp = np.asarray(jax.jit(jm.coarse_similarity)(params, jnp.asarray(a), jnp.asarray(b)))
    tp = model.coarse_similarity(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(tp, jp, atol=P_ATOL)
    j = jm.match_coarse(params, jnp.asarray(a), jnp.asarray(b))
    t = model.match_coarse(torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(t.uv_prev.numpy(), np.asarray(j.uv_prev))
    np.testing.assert_array_equal(t.uv_curr.numpy(), np.asarray(j.uv_curr))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.confidence.numpy(), np.asarray(j.confidence), atol=P_ATOL)
    assert t.valid.sum() >= 100


def test_refine_matches_fine_matches_jax(weights, pair):
    params, model = weights
    grays = pair[0]
    g1, g2 = jnp.asarray(grays[0]), jnp.asarray(grays[1])
    coarse = jm.match_coarse(params, g1, g2, top_k=64, min_confidence=0.0)
    j = jm.refine_matches_fine(params, g1, g2, coarse)
    t = model.refine_matches_fine(torch.tensor(grays[0]), torch.tensor(grays[1]),
                                  tm.Matches(*(torch.tensor(np.asarray(f)) for f in coarse)))
    _assert_matches(j, t)
    assert not np.any(t.valid.numpy() & ~np.asarray(coarse.valid))


@pytest.mark.parametrize("fine", ["zncc", "learned", "auto"])
def test_track_sparse_learned_matches_jax(weights, pair, fine):
    params, model = weights
    grays, depths, k = pair
    arrays = (grays[0], depths[0], grays[1], depths[1], k)
    key = jax.random.key(1)
    j = jax.jit(lambda key, *a: jm.track_sparse_learned(key, params, *a, fine=fine,
                                                        depth_edge_tol=0.03))(
        key, *(jnp.asarray(a) for a in arrays))
    t = tm.track_sparse_learned(model, *(torch.tensor(a) for a in arrays), fine=fine,
                                depth_edge_tol=0.03, sampler=jax_sampler(key))
    _assert_result(j, t)
    assert bool(t.success)
    assert tm.use_learned_fine(model, fine) == (fine != "zncc")


def test_torch_checkpoint_loads(weights, pair, tmp_path):
    """A ``.pt`` from the JAX package's ``save_params_torch`` (convs OIHW)
    gives the model of the ``.npz``; the ``state_dict`` wrapper unwraps;
    an unknown key raises."""
    params, model = weights
    path = tmp_path / "loftr_lite.pt"
    jm.save_params_torch(path, params)
    from_pt = tm.load_matcher(path, device="cpu")
    for name, value in model.state_dict().items():
        assert torch.equal(from_pt.state_dict()[name], value), name
    grays = pair[0]
    a, b = torch.tensor(grays[0]), torch.tensor(grays[1])
    assert torch.equal(from_pt.coarse_similarity(a, b), model.coarse_similarity(a, b))
    state = torch.load(path, weights_only=True)
    wrapped = tmp_path / "wrapped.pt"
    torch.save({"state_dict": state}, wrapped)
    assert set(tm.load_params(wrapped)) == set(params)
    torch.save({**state, "bogus_key": torch.zeros(3)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="bogus_key"):
        tm.load_params(tmp_path / "bad.pt")


@pytest.mark.parametrize("size", [(120, 160), (100, 140)])
def test_other_sizes_match_jax(size):
    """Random parameters of another topology; at 100x140 the third conv's
    input is 25x35 and ``"SAME"`` pads it by one on each side."""
    params = jm.init_params(jax.random.key(3), dim=32, layers=1, channels=(8, 16))
    model = tm.LoFTRLite.from_numpy({k: np.asarray(v) for k, v in params.items()})
    assert (model.layers, model.n_convs) == (1, 3)
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 255, size).astype(np.float32)
    b = np.roll(a, 3, axis=1)
    jp = np.asarray(jax.jit(jm.coarse_similarity)(params, jnp.asarray(a), jnp.asarray(b)))
    tp = model.coarse_similarity(torch.tensor(a), torch.tensor(b)).numpy()
    assert tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, atol=P_ATOL)
    legacy = {k: np.asarray(v) for k, v in params.items() if not k.startswith("fine_")}
    assert not tm.LoFTRLite.from_numpy(legacy).has_fine_head
    assert not tm.use_learned_fine(tm.LoFTRLite.from_numpy(legacy), "auto")
    with pytest.raises(ValueError, match="fine stage"):
        tm.use_learned_fine(model, "soft")


@pytest.mark.parametrize("fine", ["zncc", "learned"])
def test_learned_session_matches_jax(fine):
    """The session replays the JAX samples mapped through each pair's
    ranking (``test_torch_sparse.replay_session``): of the 4 pairs' 512
    ranks, 2 hold another match than in the JAX package's selection (one
    swapped pair in each, measured), each a confidence within P_ATOL of its
    neighbour's.  The learned fine head tracks this scene to 39 mm in both
    packages (the JAX package's docstring: it does not beat the ZNCC fit),
    the ZNCC fine stage to under 20 mm."""
    swaps = []
    jp, tp, js, ts, truth = run_sessions("learned", swaps=swaps, fine=fine)
    print("ranks parted a pair:", swaps)
    assert len(swaps) == 4 and max(swaps) <= 64, swaps
    assert js == ts and all(s for s in ts[1:])
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    rel = np.linalg.inv(truth[0]) @ truth
    assert np.abs(tp[:, :3, 3] - rel[:, :3, 3]).max() < (0.02 if fine == "zncc" else 0.05)
