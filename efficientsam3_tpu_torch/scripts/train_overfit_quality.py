#!/usr/bin/env python
"""Overfit-to-quality proof: train the full model on the eval fixture until
the whole inference path (processor -> postprocess -> evaluators) reports
high quality.

Counterpart of scripts/train_overfit_quality.py of the JAX package. Two
phases, both with the port's training machinery:
  1. Detector: ``train/stage3.stage3_train_step`` (the full loss stack with
     deep supervision and o2m, Hungarian matching on the host through
     ``ops/hungarian``) on the shapes fixture's (image, text-query) pairs,
     ``train_all=True`` because a run from scratch has no trained heads to
     freeze, under a cosine schedule to ~0 at ``--steps``. JAX's
     ``lax.scan`` chunks are a plain loop here that logs every ``--scan``
     steps. Dropout draws from torch's generator, seeded once.
  2. SAM heads: box-prompted mask training through the SAM1-task path
     (no-memory conditioning -> prompt encoder -> mask decoder): per
     instance BCE + dice on each of the 3 multimask outputs, the best one
     back-propagated, the IoU head regressed to the thresholded IoUs, the
     object score pushed to 1.

Checkpoints go to ``--out`` (``utils/checkpoint``: ``detector/step_<n>``
and ``tracker/step_<n>``, with the resolved config in ``config.json``);
score them with

    python -m efficientsam3_tpu_torch.scripts.eval_quality --trained <out>

Tokens come from ``ClipTokenizer`` through ``EFFICIENTSAM3_BPE_PATH``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag
from efficientsam3_tpu_torch.train.trainer import deterministic_cudnn
from efficientsam3_tpu_torch.utils.checkpoint import model_state, save_checkpoint

# The overfit fixture: 224px with 40-88px shapes. EfficientViT's last stage
# has stride 32, so at 224px the objects keep the flagship's
# object-to-cell ratio (see the JAX script for the measurements at 112px).
FIXTURE = dict(num_images=8, size=224, seed=3, r_lo=20, r_hi=44)
MODEL_CFG = dict(res=224, embed=16, ctx=16, name="b0")


def build_fixture_batch(ctx: int, res: int, device="cpu"):
    """The fixture eval_quality scores (FIXTURE) as one training batch of
    (image, query) pairs on ``device``; also (images, gt, pairs)."""
    from efficientsam3_tpu_torch.eval.coco_format import ann_to_mask
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased
    from efficientsam3_tpu_torch.utils.tokenizer import ClipTokenizer

    images, gt, pairs = make_shapes_fixture(**FIXTURE)
    size = images.shape[1]
    tokenizer = ClipTokenizer()

    by_pair = {}
    for a in gt["annotations"]:
        by_pair.setdefault(a["image_id"], []).append(a)

    t_max = max(3, max((len(v) for v in by_pair.values()), default=1))
    imgs, toks, boxes, valid, masks = [], [], [], [], []
    for pair_id, i, q in pairs:
        img = images[i].astype(np.float32) / 255.0
        imgs.append((img - 0.5) / 0.5)
        toks.append(tokenizer([q], ctx)[0])
        bx = np.zeros((t_max, 4), np.float32)
        vl = np.zeros((t_max,), bool)
        mk = np.zeros((t_max, size, size), np.float32)
        for t, a in enumerate(by_pair.get(pair_id, [])):
            x, y, w, h = a["bbox"]
            bx[t] = [(x + w / 2) / size, (y + h / 2) / size, w / size, h / size]
            vl[t] = True
            mk[t] = ann_to_mask(a, size, size)
        boxes.append(bx)
        valid.append(vl)
        masks.append(mk)

    imgs = torch.from_numpy(np.stack(imgs))
    if res != size:
        imgs = resize_antialiased(imgs, (res, res))
    batch = {
        "images": imgs.to(device),
        "tokens": torch.from_numpy(np.stack(toks)).long().to(device),
        "prompt": Prompt.empty(len(pairs), 4, 4, device=device),
        "targets": {
            "boxes": torch.from_numpy(np.stack(boxes)).to(device),
            "valid": torch.from_numpy(np.stack(valid)).to(device),
            "masks": torch.from_numpy(np.stack(masks)).to(device),
            "is_exhaustive": torch.ones((len(pairs),), dtype=torch.bool, device=device),
        },
    }
    return batch, images, gt, pairs


def train_detector(model, batch, steps, scan_len, lr, loss_weights=None):
    """``steps`` Stage-3 steps on ``batch``; trains ``model`` in place and
    returns each step's metrics as {name: [float a step]}."""
    from efficientsam3_tpu_torch.train.stage3 import (
        Stage3Config,
        make_stage3_optimizer,
        stage3_train_step,
    )

    # cosine decay to ~0 at `steps`: the late low-lr phase tightens the
    # boxes, which the IoU-aware BCE target needs before scores clear 0.5
    cfg = Stage3Config(
        vision_lr=lr, text_lr=lr, train_all=True, weight_decay=1e-4,
        warmup_steps=200, timescale=steps, schedule="cosine",
    )
    opt = make_stage3_optimizer(cfg, model)
    history = {}
    t0 = time.time()
    for step0 in range(0, steps, scan_len):
        chunk = [stage3_train_step(model, opt, batch, loss_weights=loss_weights)
                 for _ in range(min(scan_len, steps - step0))]
        metrics = {k: torch.stack([m[k] for m in chunk]).float().cpu().numpy()
                   for k in chunk[0]}
        for k, v in metrics.items():
            history.setdefault(k, []).extend(float(x) for x in v)
        ls = metrics["loss"]
        parts = sorted(
            ((k[5:], float(v[-1])) for k, v in metrics.items() if k.startswith("loss_")),
            key=lambda kv: -kv[1],
        )[:4]
        print(
            f"[detector] step {step0 + len(chunk):5d}/{steps} "
            f"loss {ls[-1]:.4f} (chunk mean {ls.mean():.4f}) "
            f"gnorm {metrics['grad_norm'][-1]:.2f} "
            f"top[{', '.join(f'{k}={v:.2f}' for k, v in parts)}] "
            f"{time.time() - t0:.0f}s",
            flush=True,
        )
        if not np.isfinite(ls).all():
            first = int(np.argmax(~np.isfinite(ls)))
            bad = {k: float(v[first]) for k, v in metrics.items() if not np.isfinite(v[first])}
            raise FloatingPointError(
                f"non-finite loss at step {step0 + first}: components {bad}; previous-step "
                f"parts {({k: round(float(v[max(first - 1, 0)]), 4) for k, v in metrics.items()})}"
            )
    model.eval().requires_grad_(False)
    return history


def train_sam_heads(model, core, images, gt, steps, scan_len, lr):
    """Phase 2: box-prompted SAM-head training of ``core`` (in place) on the
    fixture's instances over the frozen image features of ``model``;
    returns the loss of each step.

    SAM-style multimask supervision: per instance, BCE + dice on each of
    the 3 multimask outputs, only the best (least loss) one
    back-propagated; the IoU head regressed to the thresholded IoUs; the
    object score's BCE toward 1 (every prompt holds an object). The heads
    run as the JAX package's do here, in eval mode (``train=False``), and
    take optax's chain(clip_by_global_norm(5), adamw(lr, 1e-4)).
    """
    from efficientsam3_tpu_torch.eval.coco_format import ann_to_mask
    from efficientsam3_tpu_torch.ops.focal_loss import dice_loss, optax_bce
    from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased, resize_bilinear
    from efficientsam3_tpu_torch.train.stage3 import ClippedAdamW, constant_schedule

    dev = next(core.parameters()).device
    size = images.shape[1]
    res = core.image_size
    fs, d = core.feat_size, core.d_model

    # the frozen image features, once an image
    toks_l, s0_l, s1_l = [], [], []
    with torch.no_grad():
        for i in range(images.shape[0]):
            im = torch.as_tensor(images[i], device=dev).float() / 255.0
            im = resize_antialiased(im, (res, res))
            fpn = model.encode_image(((im - 0.5) / 0.5)[None])["sam2_fpn"]
            s0, s1 = core.sam_mask_decoder.high_res_convs(fpn[0], fpn[1])
            toks_l.append(fpn[2].reshape(1, fs * fs, d))
            s0_l.append(s0)
            s1_l.append(s1)

    # per-annotation training rows (box prompt in model pixel coords)
    rows_tok, rows_s0, rows_s1, rows_box, rows_mask = [], [], [], [], []
    by_img = {}
    for a in gt["annotations"]:
        info = next(im for im in gt["images"] if im["id"] == a["image_id"])
        by_img.setdefault(info["image_index"], []).append(a)
    for i, anns in by_img.items():
        for a in anns:
            x, y, w, h = a["bbox"]
            sc = res / size
            rows_box.append([x * sc, y * sc, (x + w) * sc, (y + h) * sc])
            rows_mask.append(ann_to_mask(a, size, size).astype(np.float32))
            rows_tok.append(toks_l[i][0])
            rows_s0.append(s0_l[i][0])
            rows_s1.append(s1_l[i][0])
    n = len(rows_box)
    print(f"[sam-heads] {n} box-prompted instances", flush=True)
    tok = torch.stack(rows_tok)
    s0 = torch.stack(rows_s0)
    s1 = torch.stack(rows_s1)
    boxes = torch.tensor(rows_box, dtype=torch.float32, device=dev)
    gts = torch.from_numpy(np.stack(rows_mask)).to(dev)

    # box -> 2 corner points labelled 2 / 3
    coords = torch.stack([boxes[:, :2], boxes[:, 2:]], dim=1)  # (N, 2, 2)
    labels = torch.tensor([[2, 3]], dtype=torch.long, device=dev).expand(n, 2)

    core.eval().requires_grad_(True)
    params = list(core.parameters())
    opt = ClippedAdamW({"heads": (params, constant_schedule(lr))}, weight_decay=1e-4,
                       grad_clip=5.0)

    def loss_fn():
        pix = core.no_mem_features(tok).reshape(n, fs, fs, d)
        heads = core.forward_sam_heads(pix, coords, labels, (s0, s1), True)
        mm = heads["low_res_multimasks"]  # (N, 3, h, h), gated by the object score
        k = mm.shape[1]
        up = resize_bilinear(mm.reshape(n * k, 1, *mm.shape[-2:]), (size, size)
                             ).reshape(n, k, size, size)
        tg = gts[:, None].expand(up.shape)
        bce = optax_bce(up.reshape(n * k, -1), tg.reshape(n * k, -1)).mean(-1).reshape(n, k)
        dl = dice_loss(up.reshape(n * k, 1, size, size),
                       tg.reshape(n * k, 1, size, size)).reshape(n, k)
        per = bce + dl
        best = per.detach().argmin(dim=1)
        mask_loss = per.gather(1, best[:, None]).mean()
        # the IoU head against the thresholded IoUs
        inter = ((up > 0) & (tg > 0.5)).sum((-1, -2))
        union = ((up > 0) | (tg > 0.5)).sum((-1, -2))
        actual_iou = (inter / union.clamp_min(1)).detach()
        iou_mse = ((heads["ious"] - actual_iou) ** 2).mean()
        logits = heads["object_score_logits"]
        obj_bce = optax_bce(logits, torch.ones_like(logits)).mean()
        return mask_loss + iou_mse + obj_bce

    losses = []
    t0 = time.time()
    for step0 in range(0, steps, scan_len):
        chunk = []
        for _ in range(min(scan_len, steps - step0)):
            opt.zero_grad()
            loss = loss_fn()
            loss.backward()
            opt.step()
            chunk.append(loss.detach())
        ls = torch.stack(chunk).float().cpu().numpy()
        losses.extend(float(x) for x in ls)
        print(f"[sam-heads] step {step0 + len(chunk):5d}/{steps} loss {ls[-1]:.4f} "
              f"{time.time() - t0:.0f}s", flush=True)
    core.eval().requires_grad_(False)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/overfit_quality")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--heads-steps", type=int, default=1000)
    ap.add_argument("--scan", type=int, default=50)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--heads-lr", type=float, default=4e-4)
    # the presence token is the only supervision of negative pairs (the
    # classification loss is gated off for samples without targets), so
    # the overfit recipe weights it above the Stage-3 default (20)
    ap.add_argument("--presence-weight", type=float, default=60.0)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--embed", type=int, default=None)
    ap.add_argument("--name", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # MODEL_CFG with the command line's overrides (e.g. --res 504 --embed 36
    # --name b1), written to <out>/config.json for eval_quality
    res, embed, ctx, name = (
        args.res or MODEL_CFG["res"], args.embed or MODEL_CFG["embed"],
        MODEL_CFG["ctx"], args.name or MODEL_CFG["name"],
    )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump({"res": res, "embed": embed, "ctx": ctx, "name": name}, f)
    model, core = build_efficientsam3_video_model(
        backbone_type="efficientvit", model_name=name,
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=ctx,
        embed_size=embed, device=dev, seed=0,
    )
    torch.manual_seed(42)  # the dropout masks' stream, seeded once

    batch, images, gt, pairs = build_fixture_batch(ctx, res, dev)
    print(f"fixture: {len(pairs)} (image, query) pairs, "
          f"{int(batch['targets']['valid'].sum())} instances", flush=True)

    t0 = time.time()
    with deterministic_cudnn():  # as Trainer.run: the same bits from one seed
        history = train_detector(
            model, batch, args.steps, args.scan, args.lr,
            loss_weights={"presence_loss": args.presence_weight},
        )
    t_det = time.time() - t0
    save_checkpoint(os.path.join(args.out, "detector"), args.steps, model_state(model))

    t0 = time.time()
    with deterministic_cudnn():
        heads_losses = train_sam_heads(model, core, images, gt, args.heads_steps, args.scan,
                                       args.heads_lr)
    t_heads = time.time() - t0
    save_checkpoint(os.path.join(args.out, "tracker"), args.heads_steps, model_state(core))
    summary = {"steps": args.steps, "heads_steps": args.heads_steps,
               "detector_s": t_det, "heads_s": t_heads,
               "loss_first": history["loss"][0], "loss_last": history["loss"][-1],
               "heads_loss_first": heads_losses[0] if heads_losses else None,
               "heads_loss_last": heads_losses[-1] if heads_losses else None}
    with open(os.path.join(args.out, "train_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    print(f"saved checkpoints under {args.out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
