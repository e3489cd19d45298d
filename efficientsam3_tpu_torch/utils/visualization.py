"""Copy of efficientsam3_tpu/utils/visualization.py.

Plotting helpers for masks / boxes / points on images.

Equivalent of reference sam3/sam3/visualization_utils.py for notebooks and
examples: overlay instance masks with per-object colors, draw boxes with
scores and prompt points.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _colors(n: int):
    import matplotlib.cm as cm

    cmap = cm.get_cmap("tab20")
    return [cmap(i % 20)[:3] for i in range(n)]


def overlay_masks(image: np.ndarray, masks, alpha: float = 0.5) -> np.ndarray:
    """image (H, W, 3) uint8; masks (N, H, W) bool -> blended uint8 image."""
    out = image.astype(np.float32).copy()
    for i, m in enumerate(np.asarray(masks)):
        color = np.asarray(_colors(len(masks))[i]) * 255.0
        out[m] = (1 - alpha) * out[m] + alpha * color
    return out.astype(np.uint8)


def show_predictions(
    image: np.ndarray,
    masks=None,
    boxes=None,
    scores=None,
    points=None,
    point_labels=None,
    ax=None,
    title: Optional[str] = None,
):
    """Render an image with prediction overlays (matplotlib axis)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    vis = overlay_masks(image, masks) if masks is not None and len(masks) else image
    ax.imshow(vis)
    if boxes is not None:
        cols = _colors(len(boxes))
        for i, b in enumerate(np.asarray(boxes)):
            x0, y0, x1, y1 = b
            ax.add_patch(
                Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                          edgecolor=cols[i], linewidth=2)
            )
            if scores is not None:
                ax.text(x0, y0 - 2, f"{float(scores[i]):.2f}", color=cols[i],
                        fontsize=9, weight="bold")
    if points is not None:
        pts = np.asarray(points)
        labs = (
            np.asarray(point_labels)
            if point_labels is not None
            else np.ones(len(pts), int)
        )
        pos = pts[labs == 1]
        neg = pts[labs == 0]
        if len(pos):
            ax.scatter(pos[:, 0], pos[:, 1], c="lime", marker="*", s=200,
                       edgecolors="white")
        if len(neg):
            ax.scatter(neg[:, 0], neg[:, 1], c="red", marker="*", s=200,
                       edgecolors="white")
    if title:
        ax.set_title(title)
    ax.axis("off")
    return ax
