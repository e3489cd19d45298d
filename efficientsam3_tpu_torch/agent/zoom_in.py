"""Copy of efficientsam3_tpu/agent/zoom_in.py.

Zoom-in rendering for per-mask inspection: a cropped original view
next to a magnified mask overlay, so an MLLM judge can check one
candidate mask closely.

Mirrors the reference's zoom-in geometry (sam3/sam3/agent/helpers/
zoom_in.py render_zoom_in: pad the mask box, expand the window until the
mask's relative area falls under fixed budgets, clamp shifts into the
image) but composes the two panels with numpy resizes instead of a
matplotlib figure.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .som import ColorPalette, draw_box, draw_mask, rgb_to_hex

# mask must occupy <= this fraction of its panel
AREA_LARGE = 0.25  # zoomed panel budget
AREA_MEDIUM = 0.05  # context panel budget


def _shift(x: float, extent: float, new_extent: float, limit: float) -> float:
    """Left/top shift that centers the grown window while keeping it
    inside [0, limit] (reference zoom_in._get_shift)."""
    s = (new_extent - extent) / 2
    if x - s + new_extent > limit:
        s = x + new_extent - limit
    return min(x, s)


def compute_zoom_boxes(
    box_xywh: Sequence[float], img_h: int, img_w: int, mask_area: float
) -> Tuple[list, list]:
    """(zoom_box, context_box), both xywh inside the image. The window is
    the mask box padded by max(20%, 16px), then grown so the mask covers
    at most AREA_LARGE (zoom) / AREA_MEDIUM (context) of it."""
    x, y, bw, bh = (float(v) for v in box_xywh)
    w_new = min(bw + max(0.2 * bw, 16.0), img_w)
    h_new = min(bh + max(0.2 * bh, 16.0), img_h)
    rel = mask_area / max(w_new * h_new, 1e-6)

    def grown(budget):
        gw, gh = w_new, h_new
        if rel > budget:
            r = float(np.sqrt(rel / budget))
            gw = min(w_new * r, img_w)
            gh = min(h_new * r, img_h)
        sx = _shift(x, bw, gw, img_w)
        sy = _shift(y, bh, gh, img_h)
        return [x - sx, y - sy, gw, gh]

    return grown(AREA_LARGE), grown(AREA_MEDIUM)


def _crop(img: np.ndarray, box_xywh: Sequence[float]) -> np.ndarray:
    h, w = img.shape[:2]
    x0 = max(0, int(round(box_xywh[0])))
    y0 = max(0, int(round(box_xywh[1])))
    x1 = min(w, int(round(box_xywh[0] + box_xywh[2])))
    y1 = min(h, int(round(box_xywh[1] + box_xywh[3])))
    return img[y0:y1, x0:x1]


def _resize_nn(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        return np.zeros((out_h, out_w) + img.shape[2:], img.dtype)
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
    return img[ys][:, xs]


def render_zoom_in(
    image: np.ndarray,
    mask: np.ndarray,
    box_xyxy: Sequence[float] | None = None,
    show_box: bool = True,
    mask_alpha: float = 0.15,
    panel: int = 448,
) -> Tuple[np.ndarray, str]:
    """Two-panel uint8 render for one instance: context crop (with box)
    beside a zoomed mask overlay. Returns (image, color_hex) where the
    color maximizes contrast against the instance crop — the same color
    the full-scene SoM render of this instance should then reuse
    (reference render_zoom_in returns color_hex for exactly that).

    Panels are resized to `panel` px on their long side and stacked along
    the axis that keeps them roomy (reference lays out via pyplot
    subplots 1x2 or 2x1 by aspect).
    """
    img = np.asarray(image, np.uint8)
    m = np.asarray(mask, bool)
    ys, xs = np.nonzero(m)
    if box_xyxy is None:
        if xs.size == 0:
            box_xyxy = [0, 0, img.shape[1], img.shape[0]]
        else:
            box_xyxy = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    x0, y0, x1, y1 = (float(v) for v in box_xyxy)
    box_xywh = [x0, y0, x1 - x0, y1 - y0]

    crop_region = _crop(img, box_xywh)
    palette = ColorPalette.default()
    color, _ = palette.find_farthest_color(crop_region)

    zoom_box, ctx_box = compute_zoom_boxes(
        box_xywh, img.shape[0], img.shape[1], float(m.sum())
    )

    ctx = _crop(img, ctx_box)
    if show_box:
        ctx = draw_box(
            ctx,
            [x0 - ctx_box[0], y0 - ctx_box[1], x1 - ctx_box[0], y1 - ctx_box[1]],
            color,
        )

    zoom_img = _crop(img, zoom_box)
    zoom_mask = _crop(m, zoom_box)
    zoom = draw_mask(zoom_img, zoom_mask, color, alpha=mask_alpha)

    def fit(p):
        h, w = p.shape[:2]
        s = panel / max(h, w, 1)
        return _resize_nn(p, max(int(h * s), 1), max(int(w * s), 1))

    ctx, zoom = fit(ctx), fit(zoom)
    # stack along the short axis; pad to a common extent with black
    if ctx.shape[1] < ctx.shape[0]:  # tall crops -> side by side
        h = max(ctx.shape[0], zoom.shape[0])
        pads = [
            np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)))
            for p in (ctx, zoom)
        ]
        gap = np.zeros((h, 4, 3), np.uint8)
        out = np.concatenate([pads[0], gap, pads[1]], axis=1)
    else:
        w = max(ctx.shape[1], zoom.shape[1])
        pads = [
            np.pad(p, ((0, 0), (0, w - p.shape[1]), (0, 0)))
            for p in (ctx, zoom)
        ]
        gap = np.zeros((4, w, 3), np.uint8)
        out = np.concatenate([pads[0], gap, pads[1]], axis=0)
    return out, rgb_to_hex(color)
