"""Stage-3 data augmentations (host-side numpy).

Mirrors the reference transform stack
(sam3/sam3/train/transforms/basic_for_api.py: hflip :116, resize :166,
RandomSizeCropAPI :329, RandomHorizontalFlip :583, RandomResizeAPI :600,
ColorJitter :959, RandomGrayscale :941, LargeScaleJitter :1337,
NormalizeAPI :883; filter_query_transforms.py: KeepMaxNumFindQueries :53,
FilterEmptyTargets :269; point_sampling.py; stage3
transforms/geometry_sampling.py AddGeometricQueries) on a plain sample
dict:

    {"image": (H, W, 3) uint8, "boxes": (N, 4) float xyxy abs,
     "masks": (N, H, W) bool (optional), anything else passes through}

TPU-first discipline: augmentations run on host at native resolution and
RESHAPE-FREE for the device - the final pad_to_fixed keeps fixed-width
padded targets so the jitted train step never recompiles.

A copy of efficientsam3_tpu/data/transforms.py for the port: the same
numpy code; ``center_positive_sample`` takes the port's tensor ``ops.edt``
(torch imported on first call) and returns numpy as there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _resize_image(img, out_h, out_w):
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)
    )


def _resize_masks(masks, out_h, out_w):
    from PIL import Image

    if masks is None or len(masks) == 0:
        return (
            None
            if masks is None
            else np.zeros((0, out_h, out_w), bool)
        )
    out = np.zeros((len(masks), out_h, out_w), bool)
    for i, m in enumerate(masks):
        out[i] = (
            np.asarray(
                Image.fromarray(m.astype(np.uint8) * 255).resize(
                    (out_w, out_h), Image.BILINEAR
                )
            )
            > 127
        )
    return out


def hflip(sample, rng=None):
    """Horizontal flip with box/mask sync (basic_for_api.py:116)."""
    img = sample["image"]
    w = img.shape[1]
    out = dict(sample)
    out["image"] = img[:, ::-1].copy()
    boxes = sample.get("boxes")
    if boxes is not None and len(boxes):
        b = boxes.copy()
        b[:, [0, 2]] = w - boxes[:, [2, 0]]
        out["boxes"] = b
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][:, :, ::-1].copy()
    if sample.get("input_boxes") is not None and len(sample["input_boxes"]):
        b = sample["input_boxes"].copy()
        b[:, [0, 2]] = w - sample["input_boxes"][:, [2, 0]]
        out["input_boxes"] = b
    return out


def random_hflip(sample, rng, p: float = 0.5):
    return hflip(sample) if rng.random() < p else sample


def resize(sample, size: int, max_size: Optional[int] = None, square=False):
    """Shorter-side resize preserving aspect ratio (basic_for_api.py:145-238),
    or square resize. Boxes and masks scale along."""
    img = sample["image"]
    h, w = img.shape[:2]
    if square:
        out_h = out_w = size
    else:
        scale = size / min(h, w)
        if max_size is not None and max(h, w) * scale > max_size:
            scale = max_size / max(h, w)
        out_h, out_w = int(round(h * scale)), int(round(w * scale))
    out = dict(sample)
    out["image"] = _resize_image(img, out_h, out_w)
    sx, sy = out_w / w, out_h / h
    for key in ("boxes", "input_boxes"):
        if sample.get(key) is not None and len(sample[key]):
            out[key] = sample[key] * np.asarray([sx, sy, sx, sy], np.float32)
    if sample.get("masks") is not None:
        out["masks"] = _resize_masks(sample["masks"], out_h, out_w)
    return out


def random_resize(sample, rng, sizes: Sequence[int], max_size: Optional[int] = None):
    """RandomResizeAPI (basic_for_api.py:600): pick a shorter-side size."""
    return resize(sample, int(rng.choice(list(sizes))), max_size)


def crop(sample, top, left, height, width, min_area: float = 1.0):
    """Crop with box clamping + empty-target filtering
    (basic_for_api.py:26-113)."""
    img = sample["image"]
    out = dict(sample)
    out["image"] = img[top : top + height, left : left + width].copy()
    boxes = sample.get("boxes")
    masks = sample.get("masks")
    if boxes is not None and len(boxes):
        b = boxes - np.asarray([left, top, left, top], np.float32)
        b[:, 0::2] = b[:, 0::2].clip(0, width)
        b[:, 1::2] = b[:, 1::2].clip(0, height)
        keep = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) >= min_area
        if masks is not None:
            masks = masks[:, top : top + height, left : left + width]
            keep &= masks.reshape(len(masks), -1).sum(-1) >= min_area
            out["masks"] = masks[keep].copy()
        out["boxes"] = b[keep]
        for key in ("labels", "areas", "iscrowd"):
            if sample.get(key) is not None and len(sample[key]) == len(keep):
                out[key] = np.asarray(sample[key])[keep]
    elif masks is not None:
        out["masks"] = masks[:, top : top + height, left : left + width].copy()
    return out


def random_size_crop(sample, rng, min_size: int, max_size: int):
    """RandomSizeCropAPI (basic_for_api.py:329)."""
    h, w = sample["image"].shape[:2]
    cw = int(rng.integers(min(min_size, w), min(max_size, w) + 1))
    ch = int(rng.integers(min(min_size, h), min(max_size, h) + 1))
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    return crop(sample, top, left, ch, cw)


def large_scale_jitter(sample, rng, out_size: int, scale_range=(0.1, 2.0)):
    """LargeScaleJitter (basic_for_api.py:1337): random global scale, then
    crop or pad to out_size x out_size."""
    scale = float(rng.uniform(*scale_range))
    h, w = sample["image"].shape[:2]
    sh, sw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    s = resize(sample, min(sh, sw), max_size=max(sh, sw), square=False)
    h2, w2 = s["image"].shape[:2]
    if h2 > out_size or w2 > out_size:
        top = int(rng.integers(0, max(h2 - out_size, 0) + 1))
        left = int(rng.integers(0, max(w2 - out_size, 0) + 1))
        s = crop(s, top, left, min(out_size, h2), min(out_size, w2))
        h2, w2 = s["image"].shape[:2]
    if h2 < out_size or w2 < out_size:
        img = np.zeros((out_size, out_size, 3), s["image"].dtype)
        img[:h2, :w2] = s["image"]
        s = dict(s)
        s["image"] = img
        if s.get("masks") is not None and len(s["masks"]):
            m = np.zeros((len(s["masks"]), out_size, out_size), bool)
            m[:, :h2, :w2] = s["masks"]
            s["masks"] = m
    return s


def color_jitter(sample, rng, brightness=0.4, contrast=0.4, saturation=0.4):
    """ColorJitter (basic_for_api.py:959), numpy edition."""
    img = sample["image"].astype(np.float32)
    img = img * float(rng.uniform(1 - brightness, 1 + brightness))
    mean = img.mean()
    img = (img - mean) * float(rng.uniform(1 - contrast, 1 + contrast)) + mean
    gray = img.mean(-1, keepdims=True)
    img = (img - gray) * float(rng.uniform(1 - saturation, 1 + saturation)) + gray
    out = dict(sample)
    out["image"] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def random_grayscale(sample, rng, p: float = 0.05):
    """RandomGrayscale (basic_for_api.py:941)."""
    if rng.random() >= p:
        return sample
    out = dict(sample)
    g = sample["image"].astype(np.float32).mean(-1, keepdims=True)
    out["image"] = np.repeat(g, 3, axis=-1).astype(np.uint8)
    return out


def randomize_box(box_xyxy, rng, img_hw, max_shift: float = 0.1,
                  max_scale: float = 0.2):
    """Bbox randomization for geometry queries: jitter center and scale
    while staying inside the image (the RandomGeometricInputsAPI behavior
    stage3/transforms/geometry_sampling.py expects downstream)."""
    h, w = img_hw
    x0, y0, x1, y1 = box_xyxy
    bw, bh = x1 - x0, y1 - y0
    cx = (x0 + x1) / 2 + rng.uniform(-max_shift, max_shift) * bw
    cy = (y0 + y1) / 2 + rng.uniform(-max_shift, max_shift) * bh
    s = 1.0 + rng.uniform(-max_scale, max_scale)
    bw, bh = bw * s, bh * s
    out = np.asarray(
        [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], np.float32
    )
    out[0::2] = out[0::2].clip(0, w)
    out[1::2] = out[1::2].clip(0, h)
    return out


# -- point sampling (train/transforms/point_sampling.py) --------------------


def uniform_positive_sample(mask, n_points, rng):
    """Uniform positive clicks from a mask (point_sampling.py:47).
    Returns (n, 3) [x, y, label=1]."""
    ys, xs = np.nonzero(mask)
    assert len(ys) > 0, "empty mask"
    idx = rng.integers(0, len(ys), n_points)
    pts = np.stack([xs[idx], ys[idx], np.ones(n_points)], axis=1)
    return pts.astype(np.float32)


def center_positive_sample(mask, n_points, rng=None):
    """Clicks farthest from mask edges via EDT (point_sampling.py:66)."""
    import torch

    from efficientsam3_tpu_torch.ops.edt import edt

    padded = np.pad(mask, 1).astype(bool)
    pts = []
    for _ in range(n_points):
        dist = edt(torch.from_numpy(padded)).numpy()
        y, x = np.unravel_index(int(dist.argmax()), dist.shape)
        padded[y, x] = False
        pts.append((x - 1, y - 1, 1))
    return np.asarray(pts, np.float32)


def uniform_sample_from_box(mask, box_xyxy, n_points, rng):
    """Clicks uniform in a box, labeled by the mask (point_sampling.py:95)."""
    b = np.ceil(np.asarray(box_xyxy)).astype(int)
    x = rng.integers(b[0], max(b[2], b[0] + 1), n_points)
    y = rng.integers(b[1], max(b[3], b[1] + 1), n_points)
    labels = mask[np.clip(y, 0, mask.shape[0] - 1), np.clip(x, 0, mask.shape[1] - 1)]
    return np.stack([x, y, labels], axis=1).astype(np.float32)


# -- query filtering (train/transforms/filter_query_transforms.py) ----------


def filter_empty_targets(sample):
    """FilterEmptyTargets (:269): drop zero-area boxes/empty masks."""
    boxes = sample.get("boxes")
    if boxes is None or not len(boxes):
        return sample
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    if sample.get("masks") is not None:
        keep &= sample["masks"].reshape(len(boxes), -1).any(-1)
    out = dict(sample)
    out["boxes"] = boxes[keep]
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][keep]
    return out


def keep_max_targets(sample, rng, max_targets: int):
    """KeepMaxNumFindQueries (:53): random subset when over budget."""
    boxes = sample.get("boxes")
    if boxes is None or len(boxes) <= max_targets:
        return sample
    idx = rng.choice(len(boxes), max_targets, replace=False)
    out = dict(sample)
    out["boxes"] = boxes[idx]
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][idx]
    return out


# -- finalization ------------------------------------------------------------


def normalize(sample, mean=0.5, std=0.5):
    """NormalizeAPI (:883): uint8 -> normalized float32."""
    out = dict(sample)
    out["image"] = (sample["image"].astype(np.float32) / 255.0 - mean) / std
    return out


def pad_to_fixed(sample, max_targets: int, mask_size: Optional[int] = None):
    """Fixed-width padded targets (normalized cxcywh) for the jitted step."""
    img = sample["image"]
    h, w = img.shape[:2]
    boxes_xyxy = sample.get("boxes")
    n = 0 if boxes_xyxy is None else min(len(boxes_xyxy), max_targets)
    boxes = np.zeros((max_targets, 4), np.float32)
    valid = np.zeros((max_targets,), bool)
    for i in range(n):
        x0, y0, x1, y1 = boxes_xyxy[i]
        boxes[i] = [
            (x0 + x1) / 2 / w, (y0 + y1) / 2 / h, (x1 - x0) / w, (y1 - y0) / h,
        ]
        valid[i] = True
    out = {"image": img, "boxes": boxes, "valid": valid}
    if mask_size is not None:
        masks = np.zeros((max_targets, mask_size, mask_size), np.float32)
        if sample.get("masks") is not None and n:
            resized = _resize_masks(sample["masks"][:n], mask_size, mask_size)
            masks[:n] = resized.astype(np.float32)
        out["masks"] = masks
    for k, v in sample.items():
        if k not in ("image", "boxes", "masks"):
            out[k] = v
    return out


def stage3_train_augment(sample, rng, image_size: int = 1008,
                         hflip_p: float = 0.5, use_lsj: bool = True,
                         color_p: float = 0.5):
    """The default stage-3 augmentation recipe: hflip + large-scale jitter
    (or plain square resize) + color jitter, then empty-target filtering."""
    s = random_hflip(sample, rng, hflip_p)
    if color_p and rng.random() < color_p:
        s = color_jitter(s, rng)
        s = random_grayscale(s, rng)
    if use_lsj:
        s = large_scale_jitter(s, rng, image_size)
    else:
        s = resize(s, image_size, square=True)
    return filter_empty_targets(s)
