"""LoFTR-lite: the learned detector-free coarse matcher.

Counterpart of ``dense_visual_odometry_tpu/models/matcher.py``, serving and
training halves:

- a stride-8 CNN backbone (three stride-2 3x3 convs with relu), a 2-D sine
  positional encoding on the token grid;
- ``layers`` pre-LN self- and cross-attention blocks (4 heads, full softmax
  attention as matmuls) over both images' tokens;
- the dual softmax ``P = softmax_rows(S) * softmax_cols(S)`` with a learned
  temperature, mutual-argmax selection and a fixed top-K with validity;
- the fine stage: the classical ZNCC parabola fit around each coarse match
  (``sparse.match_patches``, the default) or the learned head (a stride-2
  feature map, cosine correlation of the source vector against a 7x7 target
  window, a softmax heatmap and its soft-argmax);
- training (``apps/train_matcher.py``): ``init_params``, the ground-truth
  labels of rendered pairs (``coarse_gt_with_targets``, host numpy), and
  the two losses, ``matching_loss`` (dual-softmax cross-entropy at the true
  cells) and ``fine_loss`` (the fine head's squared pixel error,
  teacher-forced at the true cell), differentiable through
  :meth:`LoFTRLite.similarity` and the fine stage.  Every clamp of the
  forward pass differentiates as ``jnp.clip`` / ``jnp.maximum`` do: 0.5 at
  a bound (:func:`clip`), where ``torch.clamp`` gives 1.

Weights: ``load_params`` reads the JAX package's committed
``dense_visual_odometry_tpu/weights/loftr_lite.npz`` by path (``np.load``,
read-only, without importing that package), or a state-dict ``.pt`` as its
``save_params_torch`` writes it (convs OIHW).  ``params_from_numpy`` turns
the JAX layout into this module's parameters: convs HWIO -> OIHW, and an
(in, out) matrix applied as ``x @ w`` into ``F.linear``'s (out, in);
``params_to_numpy`` turns them back, and ``save_params`` /
``save_params_torch`` write the two files the JAX package reads.  The
parameters keep the JAX package's names.  Serving runs without gradients
(``requires_grad`` off, ``no_grad`` wrappers); training turns
``requires_grad`` on.

The stride-2 convs pad as XLA's ``"SAME"`` does (on an even size 0 before
and 1 after), and the layer norm takes its eps inside the rsqrt.  TF32 stays
off (the package's ``__init__``), so the convolutions and matmuls run in
full float32.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dense_visual_odometry_torch.models.dense_ba import clip_grad
from dense_visual_odometry_torch.models.sparse import (
    Matches,
    fit_from_matches,
    match_patches,
)
from dense_visual_odometry_torch.utils.ransac import first_top_k

STRIDE = 8
HEADS = 4
FINE_STRIDE = 2  # the fine feature map's stride (the shared conv stem's first level)
FINE_WIN = 7  # fine correlation window, in stride-2 cells
DEFAULT_WEIGHTS = (Path(__file__).resolve().parents[2] / "dense_visual_odometry_tpu"
                   / "weights" / "loftr_lite.npz")

_SUFFIXES = ("_w", "_b", "_q", "_k", "_v", "_o", "_ln1", "_ln1b", "_ln2", "_ln2b",
             "_mlp1", "_mlp1b", "_mlp2", "_mlp2b", "temperature")


# -- parameters ------------------------------------------------------------

def init_params(generator: torch.Generator, dim: int = 64, layers: int = 2, heads: int = 4,
                channels: Tuple[int, ...] = (32, 64)) -> Dict[str, np.ndarray]:
    """Random parameters in the JAX package's layout (convs HWIO, matrices
    (in, out)), with its keys, shapes, fan-in scales, zeros, ones and
    temperatures; the normal draws come from ``generator`` in key order."""
    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        draw = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (draw * float(scale)).numpy()

    def const(value, shape):
        return np.full(shape, value, np.float32)

    params = {}
    c_in = 1
    for i, c in enumerate((*channels, dim)):
        params[f"conv{i}_w"] = dense((3, 3, c_in, c), scale=np.sqrt(2.0 / (9 * c_in)))
        params[f"conv{i}_b"] = const(0.0, (c,))
        c_in = c
    for layer in range(layers):
        for kind in ("self", "cross"):
            p = f"l{layer}_{kind}"
            for name in ("q", "k", "v", "o"):
                params[f"{p}_{name}"] = dense((dim, dim))
            params[f"{p}_ln1"] = const(1.0, (dim,))
            params[f"{p}_ln1b"] = const(0.0, (dim,))
            params[f"{p}_ln2"] = const(1.0, (dim,))
            params[f"{p}_ln2b"] = const(0.0, (dim,))
            params[f"{p}_mlp1"] = dense((dim, 2 * dim))
            params[f"{p}_mlp1b"] = const(0.0, (2 * dim,))
            params[f"{p}_mlp2"] = dense((2 * dim, dim))
            params[f"{p}_mlp2b"] = const(0.0, (dim,))
    params["temperature"] = const(0.1, ())
    c0 = channels[0]
    params["fine_w"] = dense((3, 3, c0, c0), scale=np.sqrt(2.0 / (9 * c0)))
    params["fine_b"] = const(0.0, (c0,))
    params["fine_temperature"] = const(0.1, ())
    if heads != HEADS:
        raise ValueError(f"the head count is the module constant {HEADS}, not {heads}")
    return params


def save_params(path, params: Dict[str, np.ndarray]) -> None:
    """An ``.npz`` in the JAX layout (``params_to_numpy``'s), as the JAX
    package's ``save_params`` writes and its ``load_params`` reads."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v, np.float32) for k, v in params.items()})


def save_params_torch(path, params: Dict[str, np.ndarray]) -> None:
    """A state-dict ``.pt`` of JAX-layout parameters in the file layout of
    the JAX package's ``save_params_torch``: convs OIHW, matrices (in, out)
    as they are; its ``load_params_torch`` and :func:`load_params` read it."""
    state = {}
    for k, v in params.items():
        a = np.asarray(v, np.float32)
        if k.endswith("_w") and a.ndim == 4:  # HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        state[k] = torch.from_numpy(np.ascontiguousarray(a))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)


def load_params(path=DEFAULT_WEIGHTS) -> Dict[str, np.ndarray]:
    """The matcher's parameters in the JAX package's layout (convs HWIO,
    matrices (in, out)) from an ``.npz`` or from a state-dict ``.pt``
    (convs OIHW; a ``{"state_dict": ...}`` wrapper unwraps).  An unknown
    key raises."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as data:
            params = {k: np.asarray(data[k], np.float32) for k in data.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        params = {}
        for k, v in state.items():
            a = torch.as_tensor(v).detach().cpu().numpy().astype(np.float32)
            if k.endswith("_w") and a.ndim == 4:  # OIHW -> HWIO
                a = np.transpose(a, (2, 3, 1, 0))
            params[k] = a
    for k in params:
        if not k.endswith(_SUFFIXES):
            raise ValueError(f"unknown LoFTR-lite parameter key: {k!r}")
    return params


def params_from_numpy(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-layout parameters -> this module's: convs HWIO -> OIHW, (in, out)
    matrices -> (out, in); vectors and scalars as they are."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        elif a.ndim == 2:
            a = a.T
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """This module's parameters (``dict(model.named_parameters())``) -> the
    JAX layout: the inverse of :func:`params_from_numpy`."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy().astype(np.float32)
        if a.ndim == 4:  # OIHW -> HWIO
            a = np.transpose(a, (2, 3, 1, 0))
        elif a.ndim == 2:
            a = a.T
        elif k.endswith("temperature"):  # held as (1,), a scalar in the JAX layout
            a = a.reshape(())
        out[k] = np.ascontiguousarray(a).reshape(a.shape)
    return out


class _Clip(torch.autograd.Function):
    """``torch.clamp`` whose derivative is ``jnp.clip``'s (0.5 at a bound)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * clip_grad(x, *ctx.bounds), None, None


def clip(x: torch.Tensor, lo: float, hi: float = math.inf) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (``jnp.maximum(x, lo)`` without ``hi``):
    ``torch.clamp``'s values with the JAX derivative."""
    return _Clip.apply(x, lo, hi)


def _same_pad(x: torch.Tensor, stride: int, k: int = 3) -> torch.Tensor:
    """Pad (N, C, H, W) as XLA's ``"SAME"``: the total pad of each axis
    split with the odd pixel after."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(x, w, b, stride):
    return F.conv2d(_same_pad(x, stride), w, b, stride=stride)


def _layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _sine_pe(hc: int, wc: int, dim: int, device=None) -> torch.Tensor:
    """(hc*wc, dim) 2-D sine/cosine positional encoding."""
    d4 = dim // 4
    step = np.float32(-np.log(100.0) / max(d4 - 1, 1))
    freqs = torch.exp(torch.arange(d4, dtype=torch.float32, device=device) * float(step))
    y = torch.arange(hc, dtype=torch.float32, device=device)[:, None] * freqs[None]
    x = torch.arange(wc, dtype=torch.float32, device=device)[:, None] * freqs[None]
    pe_y = torch.cat([torch.sin(y), torch.cos(y)], -1)  # (hc, d/2)
    pe_x = torch.cat([torch.sin(x), torch.cos(x)], -1)  # (wc, d/2)
    pe = torch.cat([pe_y[:, None, :].expand(hc, wc, 2 * d4),
                    pe_x[None, :, :].expand(hc, wc, 2 * d4)], -1)
    if pe.shape[-1] < dim:
        pe = F.pad(pe, (0, dim - pe.shape[-1]))
    return pe.reshape(hc * wc, dim)


def _cell_centers(hc: int, wc: int, device=None) -> torch.Tensor:
    """(hc*wc, 2) (u, v) centres of the stride-8 cells."""
    v, u = torch.meshgrid(torch.arange(hc, dtype=torch.float32, device=device),
                          torch.arange(wc, dtype=torch.float32, device=device),
                          indexing="ij")
    off = (STRIDE - 1) / 2.0
    return torch.stack([u.reshape(-1) * STRIDE + off, v.reshape(-1) * STRIDE + off], -1)


class LoFTRLite(nn.Module):
    """The matcher with its parameters under the JAX package's names
    (``conv{i}_w``, ``l{l}_{self,cross}_{q,k,v,o,...}``, ``temperature``,
    ``fine_*``), in PyTorch's layouts."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(torch.as_tensor(v).clone(),
                                                    requires_grad=False))
        self.layers = sum(1 for k in params if k.endswith("_self_q"))
        self.n_convs = sum(1 for k in params if k.startswith("conv") and k.endswith("_w"))

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], device=None) -> "LoFTRLite":
        return cls(params_from_numpy(params)).to(device)

    def p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    @property
    def has_fine_head(self) -> bool:
        """True when the weights carry the learned fine head."""
        return hasattr(self, "fine_w")

    # -- forward -----------------------------------------------------------

    def _backbone(self, gray: torch.Tensor) -> torch.Tensor:
        """(H, W) gray in [0, 255] -> (H/8 * W/8, D) tokens with PE."""
        x = (gray / 255.0)[None, None]
        for i in range(self.n_convs):
            x = F.relu(_conv(x, self.p(f"conv{i}_w"), self.p(f"conv{i}_b"), 2))
        _, d, hc, wc = x.shape
        tokens = x[0].permute(1, 2, 0).reshape(hc * wc, d)
        return tokens + _sine_pe(hc, wc, d, tokens.device)

    def _attention(self, prefix: str, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        """Pre-LN multi-head attention (+ MLP) block: ``x`` attends to ``ctx``."""
        p = self.p
        n, d = x.shape
        dh = d // HEADS
        xn = _layer_norm(x, p(f"{prefix}_ln1"), p(f"{prefix}_ln1b"))
        cn = _layer_norm(ctx, p(f"{prefix}_ln1"), p(f"{prefix}_ln1b"))
        q = F.linear(xn, p(f"{prefix}_q")).reshape(n, HEADS, dh)
        k = F.linear(cn, p(f"{prefix}_k")).reshape(ctx.shape[0], HEADS, dh)
        v = F.linear(cn, p(f"{prefix}_v")).reshape(ctx.shape[0], HEADS, dh)
        logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("hqk,khd->qhd", att, v)
        x = x + F.linear(out.reshape(n, d), p(f"{prefix}_o"))
        xn = _layer_norm(x, p(f"{prefix}_ln2"), p(f"{prefix}_ln2b"))
        h = F.relu(F.linear(xn, p(f"{prefix}_mlp1"), p(f"{prefix}_mlp1b")))
        return x + F.linear(h, p(f"{prefix}_mlp2"), p(f"{prefix}_mlp2b"))

    def transformer_layer(self, layer: int, f1: torch.Tensor, f2: torch.Tensor):
        """One self- then cross-attention layer over both token sets."""
        f1 = self._attention(f"l{layer}_self", f1, f1)
        f2 = self._attention(f"l{layer}_self", f2, f2)
        return (self._attention(f"l{layer}_cross", f1, f2),
                self._attention(f"l{layer}_cross", f2, f1))

    def dual_softmax(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        f1 = f1 / (torch.linalg.vector_norm(f1, dim=-1, keepdim=True) + 1e-6)
        f2 = f2 / (torch.linalg.vector_norm(f2, dim=-1, keepdim=True) + 1e-6)
        s = (f1 @ f2.T) / clip(self.p("temperature"), 1e-3)
        return torch.softmax(s, dim=-1) * torch.softmax(s, dim=-2)

    def similarity(self, gray1: torch.Tensor, gray2: torch.Tensor) -> torch.Tensor:
        """-> (N1, N2) dual-softmax correspondence probabilities, with
        gradients where the parameters require them (the losses' forward)."""
        f1, f2 = self._backbone(gray1), self._backbone(gray2)
        for layer in range(self.layers):
            f1, f2 = self.transformer_layer(layer, f1, f2)
        return self.dual_softmax(f1, f2)

    @torch.no_grad()
    def coarse_similarity(self, gray1: torch.Tensor, gray2: torch.Tensor) -> torch.Tensor:
        """-> (N1, N2) dual-softmax correspondence probabilities."""
        return self.similarity(gray1, gray2)

    @staticmethod
    def select(p: torch.Tensor, hc: int, wc: int, top_k: int = 512,
               min_confidence: float = 0.2) -> Matches:
        """Mutual-argmax selection from ``p``, the top ``top_k`` by
        confidence (the lower index first among equals) -> ``Matches`` at
        the cells' centres; losers carry ``valid=False``."""
        best_j = torch.argmax(p, dim=1)
        conf = p.gather(1, best_j[:, None])[:, 0]
        rows = torch.arange(p.shape[0], device=p.device)
        mutual = torch.argmax(p, dim=0)[best_j] == rows
        conf = torch.where(mutual & (conf >= min_confidence), conf, torch.zeros_like(conf))
        top_i = first_top_k(conf, min(top_k, conf.shape[0]))
        top_conf = conf[top_i]
        centers = _cell_centers(hc, wc, p.device)
        return Matches(uv_prev=centers[top_i], uv_curr=centers[best_j[top_i]],
                       confidence=top_conf, valid=top_conf > 0.0)

    @torch.no_grad()
    def match_coarse(self, gray1: torch.Tensor, gray2: torch.Tensor, top_k: int = 512,
                     min_confidence: float = 0.2) -> Matches:
        """Learned coarse matching -> fixed-size ``Matches`` (8-px centres)."""
        h, w = gray1.shape
        p = self.coarse_similarity(gray1, gray2)
        return self.select(p, h // STRIDE, w // STRIDE, top_k, min_confidence)

    def _fine_features(self, gray: torch.Tensor) -> torch.Tensor:
        """(H, W) gray -> (H/2, W/2, C) fine feature map: the backbone's
        first conv, then the fine head's conv (linear)."""
        x = (gray / 255.0)[None, None]
        x = F.relu(_conv(x, self.p("conv0_w"), self.p("conv0_b"), 2))
        x = _conv(x, self.p("fine_w"), self.p("fine_b"), 1)
        return x[0].permute(1, 2, 0)

    def _fine_correlate(self, f1, f2, uv1, uv2):
        """Correlate source centre vectors against target windows.

        f1/f2 : (H2, W2, C) fine maps; uv1/uv2 : (K, 2) full-res pixels
        (source position / coarse target prediction).  -> (uv_pred (K, 2),
        peak (K,), ok (K,)): the soft-argmax target, the heatmap's peak
        probability, and whether the window centre was in bounds."""
        h2, w2, _ = f2.shape
        off = (FINE_STRIDE - 1) / 2.0
        i1 = torch.round((uv1[:, 1] - off) / FINE_STRIDE).to(torch.int64).clamp(0, h2 - 1)
        j1 = torch.round((uv1[:, 0] - off) / FINE_STRIDE).to(torch.int64).clamp(0, w2 - 1)
        cvec = f1[i1, j1]  # (K, C)
        r = FINE_WIN // 2
        i2 = torch.round((uv2[:, 1] - off) / FINE_STRIDE).to(torch.int64)
        j2 = torch.round((uv2[:, 0] - off) / FINE_STRIDE).to(torch.int64)
        rr = torch.arange(-r, r + 1, device=f2.device)
        dy, dx = torch.meshgrid(rr, rr, indexing="ij")
        dy, dx = dy.reshape(-1), dx.reshape(-1)
        vi = i2[:, None] + dy[None]
        ui = j2[:, None] + dx[None]
        inb = (vi >= 0) & (vi < h2) & (ui >= 0) & (ui < w2)
        win = f2[vi.clamp(0, h2 - 1), ui.clamp(0, w2 - 1)]  # (K, W^2, C)
        cvec = cvec * torch.rsqrt((cvec * cvec).sum(-1, keepdim=True) + 1e-8)
        win = win * torch.rsqrt((win * win).sum(-1, keepdim=True) + 1e-8)
        temp = clip(self.p("fine_temperature"), 1e-3)
        logits = torch.einsum("kc,kwc->kw", cvec, win) / temp
        heat = torch.softmax(torch.where(inb, logits, torch.full_like(logits, -1e9)), dim=-1)
        exp_dy = heat @ dy.to(torch.float32)
        exp_dx = heat @ dx.to(torch.float32)
        uv_pred = torch.stack([(j2.to(torch.float32) + exp_dx) * FINE_STRIDE + off,
                               (i2.to(torch.float32) + exp_dy) * FINE_STRIDE + off], -1)
        peak = heat.amax(-1)
        ok = (i2 >= 0) & (i2 < h2) & (j2 >= 0) & (j2 < w2)
        return uv_pred, peak, ok

    @torch.no_grad()
    def refine_matches_fine(self, gray1: torch.Tensor, gray2: torch.Tensor,
                            matches: Matches) -> Matches:
        """The learned fine stage: subpixel targets by the fine head;
        confidence becomes ``coarse * heat peak``, and windows centred out
        of bounds are invalidated."""
        f1, f2 = self._fine_features(gray1), self._fine_features(gray2)
        uv_pred, peak, ok = self._fine_correlate(f1, f2, matches.uv_prev, matches.uv_curr)
        return Matches(uv_prev=matches.uv_prev, uv_curr=uv_pred,
                       confidence=matches.confidence * peak, valid=matches.valid & ok)


def selection_order(reference: Matches, matches: Matches) -> torch.Tensor:
    """(K,) the rows of ``matches`` in ``reference``'s order, paired by
    source cell (a selection holds each cell once), on the CPU.  Two runs of
    the matcher whose probabilities part by rounding may rank near-equal
    confidences apart, and RANSAC samples rows by rank: this maps one run's
    samples onto the other's.  Raises if they select different matches."""
    ref = reference.uv_prev.cpu().tolist()
    rows = {tuple(uv): i for i, uv in enumerate(matches.uv_prev.cpu().tolist())}
    if set(rows) != {tuple(uv) for uv in ref}:
        raise ValueError("the two selections hold different source cells")
    order = torch.tensor([rows[tuple(uv)] for uv in ref], dtype=torch.int64)
    for field in ("uv_curr", "valid"):
        if not torch.equal(getattr(reference, field).cpu(), getattr(matches, field).cpu()[order]):
            raise ValueError(f"the two selections part in {field}")
    return order


def load_matcher(path=DEFAULT_WEIGHTS, device=None) -> LoFTRLite:
    """The matcher with the weights at ``path`` (``.npz`` or ``.pt``) on
    ``device``, in eval mode."""
    return LoFTRLite.from_numpy(load_params(path), device).eval()


def use_learned_fine(model: LoFTRLite, fine: str) -> bool:
    if fine not in ("zncc", "learned", "auto"):
        raise ValueError(f"unknown fine stage {fine!r}: 'zncc', 'learned' or 'auto'")
    return fine == "learned" or (fine == "auto" and model.has_fine_head)


@torch.no_grad()
def track_sparse_learned(
    model: LoFTRLite,
    gray_prev: torch.Tensor,
    depth_prev_m: torch.Tensor,
    gray_curr: torch.Tensor,
    depth_curr_m: torch.Tensor,
    intrinsics: torch.Tensor,
    *,
    top_k: int = 512,
    min_confidence: float = 0.2,
    refine_search: int = 6,
    min_zncc: float = 0.5,
    fine: str = "zncc",
    **fit_kwargs,
):
    """Learned coarse matches -> subpixel refinement -> the RANSAC rigid
    tail (``sparse.fit_from_matches``; ``sampler`` or ``generator`` among
    ``fit_kwargs``).  ``fine``: ``"zncc"`` (the parabola fit, the default),
    ``"learned"`` (the fine head) or ``"auto"`` (learned iff the weights
    have one)."""
    coarse = model.match_coarse(gray_prev, gray_curr, top_k=top_k,
                                min_confidence=min_confidence)
    if use_learned_fine(model, fine):
        matches = model.refine_matches_fine(gray_prev, gray_curr, coarse)
    else:
        zncc = match_patches(gray_prev, gray_curr, coarse.uv_prev,
                             centers_curr=coarse.uv_curr, search=refine_search,
                             min_zncc=min_zncc)
        matches = zncc._replace(valid=zncc.valid & coarse.valid,
                                confidence=zncc.confidence * coarse.confidence)
    return fit_from_matches(matches, depth_prev_m, depth_curr_m, intrinsics, **fit_kwargs)



# -- training labels and losses ----------------------------------------------

def coarse_gt_assignment(
    depth1_m: np.ndarray,
    depth2_m: np.ndarray,
    intrinsics: np.ndarray,
    transform_1_to_2: np.ndarray,
    occlusion_tol: float = 0.05,
) -> np.ndarray:
    """Ground-truth coarse assignment (host, once per training pair).

    -> (N1,) int32: target cell index per source cell, -1 where the cell
    centre has no valid visible correspondence.
    """
    return coarse_gt_with_targets(
        depth1_m, depth2_m, intrinsics, transform_1_to_2, occlusion_tol
    )[0]


def coarse_gt_with_targets(
    depth1_m: np.ndarray,
    depth2_m: np.ndarray,
    intrinsics: np.ndarray,
    transform_1_to_2: np.ndarray,
    occlusion_tol: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth coarse assignment and continuous targets (host numpy,
    once per training pair; the JAX package's arithmetic, bit for bit).

    -> ``(gt (N1,) int32, uv_target (N1, 2) float32)``: the target cell of
    each source cell centre (-1 where it has no visible correspondence) and
    the continuous warped pixel (junk where ``gt < 0``), the fine head's
    target.  Exact depth and relative pose, with an occlusion check against
    the target depth map.
    """
    h, w = depth1_m.shape
    hc, wc = h // STRIDE, w // STRIDE
    off = (STRIDE - 1) / 2.0
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    vs, us = np.meshgrid(np.arange(hc), np.arange(wc), indexing="ij")
    u = us.ravel() * STRIDE + off
    v = vs.ravel() * STRIDE + off
    z = depth1_m[np.round(v).astype(int), np.round(u).astype(int)]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x, y, z], -1) @ transform_1_to_2[:3, :3].T + transform_1_to_2[:3, 3]
    zt = pts[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        ut = pts[:, 0] / zt * fx + cx
        vt = pts[:, 1] / zt * fy + cy
    # Zero source depth divides to nan / inf: a value the bounds reject
    # (those cells are dropped by z > 0 anyway).
    ut = np.nan_to_num(ut, nan=-1.0, posinf=-1.0, neginf=-1.0)
    vt = np.nan_to_num(vt, nan=-1.0, posinf=-1.0, neginf=-1.0)
    uc = np.floor(ut / STRIDE).astype(np.int64)
    vc = np.floor(vt / STRIDE).astype(np.int64)
    inside = (z > 0) & (zt > 1e-6) & (uc >= 0) & (uc < wc) & (vc >= 0) & (vc < hc)
    # Occlusion: the target depth at the landing pixel must agree.
    ui = np.clip(np.round(ut), 0, w - 1).astype(int)
    vi = np.clip(np.round(vt), 0, h - 1).astype(int)
    z2 = depth2_m[vi, ui]
    visible = inside & (z2 > 0) & (np.abs(z2 - zt) <= occlusion_tol * np.maximum(zt, 0.5))
    gt = np.where(visible, vc * wc + uc, -1)
    uv_target = np.stack([ut, vt], axis=-1).astype(np.float32)
    return gt.astype(np.int32), uv_target


def _masked_mean(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """sum(values where keep) / max(count(keep), 1)."""
    kept = torch.where(keep, values, torch.zeros_like(values))
    return kept.sum() / keep.sum().clamp(min=1)


def matching_loss(model: LoFTRLite, gray1: torch.Tensor, gray2: torch.Tensor,
                  gt_assignment: torch.Tensor) -> torch.Tensor:
    """Dual-softmax cross-entropy at the ground-truth cells (LoFTR's coarse
    loss): ``-mean log P[i, gt_i]`` over the cells with a correspondence."""
    p = model.similarity(gray1, gray2)
    gt = gt_assignment.long()
    picked = p.gather(1, gt.clamp(0, p.shape[1] - 1)[:, None])[:, 0]
    return _masked_mean(-torch.log(clip(picked, 1e-9, 1.0)), gt >= 0)


def fine_loss(model: LoFTRLite, gray1: torch.Tensor, gray2: torch.Tensor,
              gt_assignment: torch.Tensor, uv_target: torch.Tensor) -> torch.Tensor:
    """The fine stage's loss (LoFTR's l_f), teacher-forced: each source cell
    centre against the window around its ground-truth cell, the squared
    pixel error of the soft-argmax against ``uv_target``."""
    h, w = gray1.shape
    hc, wc = h // STRIDE, w // STRIDE
    f1, f2 = model._fine_features(gray1), model._fine_features(gray2)
    gt = gt_assignment.long()
    centers = _cell_centers(hc, wc, gray1.device)
    uv_pred, _, ok = model._fine_correlate(f1, f2, centers, centers[gt.clamp(0, hc * wc - 1)])
    err = ((uv_pred - uv_target) ** 2).sum(-1)
    return _masked_mean(err, (gt >= 0) & ok)
