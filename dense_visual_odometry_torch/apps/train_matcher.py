"""Train the LoFTR-lite matcher on rendered pairs.

Counterpart of ``dense_visual_odometry_tpu/apps/train_matcher.py``: the
frames of a bundled-format directory (``ground_truth.json``,
``camera_intrinsics.yaml`` and PNGs) are re-rendered from random SE(3)
viewpoints with exact depth (``io/synthetic.render_view``), which gives exact
coarse-cell labels (with occlusion checks) for the dual-softmax
cross-entropy and subpixel targets for the fine head's loss.

Usage::

    python -m dense_visual_odometry_torch.apps.train_matcher --data-dir DIR \\
        -o dense_visual_odometry_torch/weights/loftr_lite.npz \\
        --steps 800 --pairs 48 --scale 0.5

It trains on the GPU; ``--platform cpu`` runs the same steps on the CPU.
The dataset is built on the host with the JAX package's random stream and
cv2 calls, so it equals that package's bit for bit, and is uploaded once.
Adam over a cosine decay is ``optax.adam(optax.cosine_decay_schedule(lr,
steps))``: ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8) with the rate
``lr * 0.5 * (1 + cos(pi * min(t, T) / T))`` at step t.  The weights are
written in the JAX layout (``.npz``), which both packages' ``load_params``
read; the default output lies in this package, never in the JAX package's
committed weights.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

DEFAULT_OUTPUT = Path(__file__).resolve().parents[1] / "weights" / "loftr_lite.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train LoFTR-lite matcher")
    ap.add_argument("-o", "--output", type=str, default=str(DEFAULT_OUTPUT))
    ap.add_argument("--data-dir", type=str, default=None, help="bundled set dir")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--pairs", type=int, default=48, help="rendered training pairs")
    ap.add_argument("--holdout", type=int, default=8, help="extra eval pairs")
    ap.add_argument("--scale", type=float, default=0.5, help="training resolution scale")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--max-rot", type=float, default=0.08, help="rad/axis")
    ap.add_argument("--max-trans", type=float, default=0.08, help="m/axis")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", type=str, default=None, choices=["cuda", "cpu"],
                    help="the device (default: the GPU)")
    ap.add_argument(
        "--no-augment", action="store_true",
        help="disable photometric + multi-scale-crop augmentation",
    )
    ap.add_argument(
        "--fine-weight", type=float, default=0.25,
        help="fine-stage loss weight (0 disables fine-head training)",
    )
    return ap.parse_args(argv)


def _random_se3(rng, max_rot, max_trans):
    """A random rigid motion (Rodrigues) from ``rng``: half the draws are
    damped to a quarter, so that the matcher also learns near-identity
    alignment (the odometry regime)."""
    import numpy as np

    w = rng.uniform(-max_rot, max_rot, 3)
    t = rng.uniform(-max_trans, max_trans, 3)
    if rng.random() < 0.5:
        w *= 0.25
        t *= 0.25
    th = float(np.linalg.norm(w))
    kx = np.array([
        [0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]
    ])
    r = np.eye(3)
    if th > 1e-12:
        r = r + np.sin(th) / th * kx + (1 - np.cos(th)) / th**2 * (kx @ kx)
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def build_dataset(args):
    """-> dict of stacked numpy arrays: gray1/gray2 (P,H,W), gt (P,N),
    uv_target (P,N,2), on the host."""
    import cv2
    import numpy as np

    from dense_visual_odometry_torch.io import load_bundled_sequence
    from dense_visual_odometry_torch.io.synthetic import render_view
    from dense_visual_odometry_torch.models.matcher import STRIDE, coarse_gt_with_targets

    seq = load_bundled_sequence(args.data_dir)
    rng = np.random.default_rng(args.seed)
    n_total = args.pairs + args.holdout
    augment = not getattr(args, "no_augment", False)
    g1s, g2s, gts, uvts = [], [], [], []
    k = np.asarray(seq.camera.intrinsics, np.float64).copy()
    for p in range(n_total):
        rgb, depth = seq.frame(p % len(seq))
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32)
        depth_m = depth.astype(np.float32) * seq.camera.depth_scale
        ks = k.copy()
        if augment and rng.random() < 0.6:
            # Multi-scale crop (zoom augmentation): a random sub-window
            # resized back to the full frame, intrinsics adjusted, so that
            # the matcher sees the textures across feature scales.
            c = float(rng.uniform(0.6, 0.9))
            ch = int(gray.shape[0] * c)
            cw = int(gray.shape[1] * c)
            oy = int(rng.integers(0, gray.shape[0] - ch + 1))
            ox = int(rng.integers(0, gray.shape[1] - cw + 1))
            gray = gray[oy : oy + ch, ox : ox + cw]
            depth_m = depth_m[oy : oy + ch, ox : ox + cw]
            ks[0, 2] -= ox
            ks[1, 2] -= oy
            zx = rgb.shape[1] / cw
            zy = rgb.shape[0] / ch
            gray = cv2.resize(gray, (rgb.shape[1], rgb.shape[0]),
                              interpolation=cv2.INTER_LINEAR)
            depth_m = cv2.resize(depth_m, (rgb.shape[1], rgb.shape[0]),
                                 interpolation=cv2.INTER_NEAREST)
            ks[0] *= zx
            ks[1] *= zy
        if args.scale != 1.0:
            h = int(gray.shape[0] * args.scale) // STRIDE * STRIDE
            w = int(gray.shape[1] * args.scale) // STRIDE * STRIDE
            sh, sw = gray.shape
            gray = cv2.resize(gray, (w, h), interpolation=cv2.INTER_AREA)
            depth_m = cv2.resize(depth_m, (w, h), interpolation=cv2.INTER_NEAREST)
            ks[0] *= w / sw
            ks[1] *= h / sh
        t = _random_se3(rng, args.max_rot, args.max_trans)
        g2, d2 = render_view(gray, depth_m, ks, t)
        gt, uvt = coarse_gt_with_targets(depth_m, d2, ks, t)
        if augment:
            # Photometric augmentation: an exposure gain and bias per image
            # and Gaussian sensor noise, so that the dual softmax does not
            # rely on absolute intensity.
            for g in (gray, g2):
                gain = float(rng.uniform(0.9, 1.1))
                bias = float(rng.uniform(-8.0, 8.0))
                noise = rng.standard_normal(g.shape) * 2.0
                np.copyto(g, np.clip(g * gain + bias + noise, 0.0, 255.0))
        g1s.append(gray)
        g2s.append(g2)
        gts.append(gt)
        uvts.append(uvt)
    return {
        "gray1": np.stack(g1s), "gray2": np.stack(g2s), "gt": np.stack(gts),
        "uv_target": np.stack(uvts),
    }


def real_pair_dataset(pairs, data_dir=None, scale=0.5):
    """Evaluation pairs of two real frames each (no rendering), labelled
    from measured depth and the ground-truth relative pose: a check outside
    the training distribution (real frame, rendered view).

    pairs : iterable of (i, j) frame indices.  -> dict like
    :func:`build_dataset`.
    """
    import cv2
    import numpy as np

    from dense_visual_odometry_torch.io import load_bundled_sequence
    from dense_visual_odometry_torch.models.matcher import STRIDE, coarse_gt_with_targets

    seq = load_bundled_sequence(data_dir)
    k0 = np.asarray(seq.camera.intrinsics, np.float64)

    def load(i):
        rgb, depth = seq.frame(i)
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32)
        depth_m = depth.astype(np.float32) * seq.camera.depth_scale
        h = int(gray.shape[0] * scale) // STRIDE * STRIDE
        w = int(gray.shape[1] * scale) // STRIDE * STRIDE
        ks = k0.copy()
        ks[0] *= w / gray.shape[1]
        ks[1] *= h / gray.shape[0]
        gray = cv2.resize(gray, (w, h), interpolation=cv2.INTER_AREA)
        depth_m = cv2.resize(depth_m, (w, h), interpolation=cv2.INTER_NEAREST)
        return gray, depth_m, ks

    g1s, g2s, gts, uvts = [], [], [], []
    for i, j in pairs:
        g1, d1, ks = load(i)
        g2, d2, _ = load(j)
        # transform_1_to_2: camera_i points into camera_j.
        t = np.linalg.inv(seq.gt_poses[j]) @ seq.gt_poses[i]
        gt, uvt = coarse_gt_with_targets(d1, d2, ks, t)
        gts.append(gt)
        uvts.append(uvt)
        g1s.append(g1)
        g2s.append(g2)
    return {
        "gray1": np.stack(g1s), "gray2": np.stack(g2s), "gt": np.stack(gts),
        "uv_target": np.stack(uvts),
    }


def evaluate(model, data, idx):
    """Cell-level precision / recall of the mutual matches on the pairs
    ``idx`` of ``data`` (host arrays), on the model's device."""
    import numpy as np
    import torch

    from dense_visual_odometry_torch.models.matcher import STRIDE

    dev = next(model.parameters()).device
    precisions, recalls = [], []
    for i in idx:
        m = model.match_coarse(torch.as_tensor(data["gray1"][i], device=dev),
                               torch.as_tensor(data["gray2"][i], device=dev), top_k=512)
        gt = np.asarray(data["gt"][i])
        wc = data["gray1"].shape[2] // STRIDE
        valid = m.valid.cpu().numpy()
        if valid.sum() == 0:
            precisions.append(0.0)
            recalls.append(0.0)
            continue
        src = m.uv_prev.cpu().numpy()[valid]
        dst = m.uv_curr.cpu().numpy()[valid]
        ci = (src[:, 1] // STRIDE).astype(int) * wc + (src[:, 0] // STRIDE).astype(int)
        cj = (dst[:, 1] // STRIDE).astype(int) * wc + (dst[:, 0] // STRIDE).astype(int)
        has_gt = gt[ci] >= 0
        # Correct when the predicted target cell is the true cell or a
        # direct neighbour (the fine stage absorbs one cell of error).
        gj = gt[ci]
        dy = np.abs(cj // wc - gj // wc)
        dx = np.abs(cj % wc - gj % wc)
        good = has_gt & (dy <= 1) & (dx <= 1)
        precisions.append(float(good.sum()) / max(int(has_gt.sum()), 1))
        recalls.append(float(good.sum()) / max(int((gt >= 0).sum()), 1))
    return float(np.mean(precisions)), float(np.mean(recalls))


def evaluate_fine(model, data, idx):
    """Teacher-forced subpixel error (px) of the fine stage on the pairs
    ``idx``, against the coarse-cell-centre baseline."""
    import numpy as np
    import torch

    from dense_visual_odometry_torch.models.matcher import STRIDE, _cell_centers

    dev = next(model.parameters()).device
    fine_errs, base_errs = [], []
    with torch.no_grad():
        for i in idx:
            g1 = data["gray1"][i]
            gt = np.asarray(data["gt"][i])
            uvt = np.asarray(data["uv_target"][i])
            hc, wc = g1.shape[0] // STRIDE, g1.shape[1] // STRIDE
            f1 = model._fine_features(torch.as_tensor(g1, device=dev))
            f2 = model._fine_features(torch.as_tensor(data["gray2"][i], device=dev))
            centers = _cell_centers(hc, wc).numpy()
            valid = gt >= 0
            gtc = np.clip(gt, 0, hc * wc - 1)
            uv_pred, _, ok = model._fine_correlate(
                f1, f2, torch.as_tensor(centers, device=dev),
                torch.as_tensor(centers[gtc], device=dev))
            keep = valid & ok.cpu().numpy()
            if keep.sum() == 0:
                continue
            fine_errs.append(float(np.mean(np.linalg.norm(
                uv_pred.cpu().numpy()[keep] - uvt[keep], axis=-1))))
            base_errs.append(float(np.mean(np.linalg.norm(
                centers[gtc][keep] - uvt[keep], axis=-1))))
    return float(np.mean(fine_errs)), float(np.mean(base_errs))


def cosine_decay(step: int, steps: int) -> float:
    """``optax.cosine_decay_schedule``'s factor at ``step`` (alpha 0)."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))


def make_optimizer(model, lr: float, steps: int):
    """-> (Adam over the model's parameters, its cosine-decay scheduler):
    ``optax.adam(optax.cosine_decay_schedule(lr, steps))``.  Turns the
    parameters' ``requires_grad`` on."""
    import torch

    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: cosine_decay(t, steps))


def train_step(model, opt, sched, data, i: int, fine_weight: float):
    """One Adam step of the joint loss (coarse + ``fine_weight`` * fine) on
    pair ``i`` of ``data`` (tensors on the model's device) -> the loss before
    the step (a 0-d tensor)."""
    from dense_visual_odometry_torch.models.matcher import fine_loss, matching_loss

    g1, g2, gt, uvt = (data[k][i] for k in ("gray1", "gray2", "gt", "uv_target"))
    opt.zero_grad(set_to_none=True)
    loss = matching_loss(model, g1, g2, gt) + fine_weight * fine_loss(model, g1, g2, gt, uvt)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def upload(data, device) -> dict:
    """The dataset's arrays as tensors on ``device``."""
    import torch

    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def main(argv=None) -> dict:
    """Train, evaluate on the holdout pairs and write the weights; prints
    the progress and the summary line of the JAX package's tool.  -> the
    summary, with the per-step losses (``losses``), the host-to-host step
    seconds (``step_s``) and the dataset's build seconds (``dataset_s``)."""
    import numpy as np
    import torch

    from dense_visual_odometry_torch.models import matcher
    from dense_visual_odometry_torch.models.robust import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.platform)
    t0 = time.time()
    data = build_dataset(args)
    dataset_s = time.time() - t0
    print(f"dataset: {data['gray1'].shape} rendered in {dataset_s:.1f}s", flush=True)

    params = matcher.init_params(torch.Generator().manual_seed(args.seed),
                                 dim=args.dim, layers=args.layers)
    model = matcher.LoFTRLite.from_numpy(params, device)
    opt, sched = make_optimizer(model, args.lr, args.steps)
    dev = upload(data, device)

    rng = np.random.default_rng(args.seed + 1)
    train_idx = np.arange(args.pairs)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(args.steps):
        i = int(rng.choice(train_idx))
        ts = time.perf_counter()
        losses.append(float(train_step(model, opt, sched, dev, i, args.fine_weight)))
        step_s.append(time.perf_counter() - ts)
        if step % 100 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {np.mean(losses[-100:]):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    model.eval()
    hold = np.arange(args.pairs, args.pairs + args.holdout)
    prec, rec = evaluate(model, data, hold)
    fine_px, coarse_px = evaluate_fine(model, data, hold)
    print(f"holdout: precision@1cell {prec:.3f} recall {rec:.3f}", flush=True)
    print(f"holdout fine: {fine_px:.2f} px (coarse-center baseline "
          f"{coarse_px:.2f} px)", flush=True)

    matcher.save_params(args.output, matcher.params_to_numpy(dict(model.named_parameters())))
    print(f"weights -> {args.output}")
    summary = {
        "final_loss": float(np.mean(losses[-50:])),
        "holdout_precision": prec, "holdout_recall": rec,
        "holdout_fine_px": fine_px, "holdout_coarse_px": coarse_px,
        "steps": args.steps, "pairs": args.pairs, "scale": args.scale,
    }
    print(json.dumps(summary))
    return {**summary, "losses": losses, "step_s": step_s, "dataset_s": dataset_s}


if __name__ == "__main__":
    main()
