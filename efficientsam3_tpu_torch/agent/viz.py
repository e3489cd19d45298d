"""Copy of efficientsam3_tpu/agent/viz.py.

Unified agent visualization (reference sam3/sam3/agent/viz.py
visualize): full-scene SoM render, or a (single-instance render,
zoom-in pair) for one index.

Results are in-memory dicts — {"image": (H, W, 3) uint8, "masks":
[(H, W) bool], "boxes": [[x0, y0, x1, y1]], "scores": [float]} — rather
than the reference's path-and-RLE json files; the agent loop here runs
in-process against the jitted model, so round-tripping pixels through
PNG/RLE files would only add host latency.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .som import ColorPalette, overlay_instances
from .zoom_in import render_zoom_in


def _hex_to_rgb(h: str):
    h = h.lstrip("#")
    return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))


def visualize(
    result: dict,
    zoom_in_index: Optional[int] = None,
    mask_alpha: float = 0.35,
    label_mode: str = "1",
):
    """Full-scene SoM image, or (single-instance image, zoom-in image)
    when `zoom_in_index` is given — the single-instance render reuses the
    contrast color the zoom-in picked, exactly as the reference pairs
    them (viz.py Mode B)."""
    image = np.asarray(result["image"], np.uint8)
    masks = [np.asarray(m, bool) for m in result.get("masks", [])]
    boxes = result.get("boxes")

    if zoom_in_index is None:
        return overlay_instances(
            image, masks, boxes, alpha=mask_alpha, label_mode=label_mode
        )

    idx = int(zoom_in_index)
    if not 0 <= idx < len(masks):
        raise ValueError(
            f"zoom_in_index {idx} out of range (0..{len(masks) - 1})"
        )
    box = boxes[idx] if boxes is not None else None
    zoomed, color_hex = render_zoom_in(image, masks[idx], box, mask_alpha=0.15)
    single = overlay_instances(
        image,
        [masks[idx]],
        [box] if box is not None else None,
        assigned_colors=[_hex_to_rgb(color_hex)],
        alpha=mask_alpha,
        label_mode=label_mode,
    )
    return single, zoomed
