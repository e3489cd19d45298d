"""COCO-format utilities without pycocotools.

A copy of efficientsam3_tpu/eval/coco_format.py (numpy only; PIL imported
lazily for polygons). Self-contained replacements for the pycocotools
pieces the reference eval stack leans on (RLE encode/decode, polygon
rasterization, ann loading), so the evaluators run in any environment.
COCO compressed RLE strings follow the standard LEB128-style encoding used
by the dataset tooling.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """(H, W) bool -> uncompressed RLE dict (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major (Fortran)
    # run lengths starting with zeros
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_decode_string(counts)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T


def rle_encode_string(counts) -> str:
    """COCO compressed RLE string from integer counts (maskUtils format)."""
    s = []
    prev = 0
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == -1 if (c & 0x10) else x == 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def rle_decode_string(s) -> list:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def polygons_to_mask(polys, h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> (H, W) bool via PIL rasterization."""
    from PIL import Image, ImageDraw

    img = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, bool)


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    raise ValueError("unknown segmentation format")


def mask_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """(N, H, W) x (M, H, W) bool -> (N, M) IoU, numpy."""
    af = a.reshape(a.shape[0], -1).astype(np.float64)
    bf = b.reshape(b.shape[0], -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None] - inter
    return inter / np.maximum(union, eps)


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """(N, 4) x (M, 4) xywh (COCO boxes) -> (N, M) IoU."""
    ax2 = a[:, 0] + a[:, 2]
    ay2 = a[:, 1] + a[:, 3]
    bx2 = b[:, 0] + b[:, 2]
    by2 = b[:, 1] + b[:, 3]
    ix = np.maximum(
        0, np.minimum(ax2[:, None], bx2[None]) - np.maximum(a[:, None, 0], b[None, :, 0])
    )
    iy = np.maximum(
        0, np.minimum(ay2[:, None], by2[None]) - np.maximum(a[:, None, 1], b[None, :, 1])
    )
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, eps)


class CocoDataset:
    """Minimal COCO json reader (images / annotations / categories)."""

    def __init__(self, path_or_dict):
        d = path_or_dict
        if isinstance(d, str):
            with open(d) as f:
                d = json.load(f)
        self.images = {im["id"]: im for im in d.get("images", [])}
        self.categories = {c["id"]: c for c in d.get("categories", [])}
        self.img_anns: dict = {im_id: [] for im_id in self.images}
        for ann in d.get("annotations", []):
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def annotations(self, image_id, category_id: Optional[int] = None):
        anns = self.img_anns.get(image_id, [])
        if category_id is None:
            return anns
        return [a for a in anns if a["category_id"] == category_id]
