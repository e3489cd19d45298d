"""Connected components (8-connectivity) and hole filling of mask scores.

Counterpart of efficientsam3_tpu/ops/cc.py, same contract: labels (H, W)
int32, 0 for background and root-index + 1 for foreground, the root being
the component's smallest linear pixel index (stable within a component,
not compacted); ``component_areas`` counts pixels per label;
``fill_holes_in_mask_scores`` patches small background components to +0.1
and, with ``remove_sprinkles``, small foreground components of the patched
map to -0.1.

The JAX version's pointer jumping exists because the TPU has no atomics for
union-find; here the tensor version is plain min-label propagation (a 3x3
max-pool of the negated labels per sweep until nothing changes), which is
enough beside the host path: the video pipeline fills holes on the host,
``fill_holes_in_mask_scores_host``, over the port's copy of the host C++
library (``native``), or over scipy when the caller asks for the CPU path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def connected_components(mask, max_iters: int = 4096):
    """mask (H, W) bool -> labels (H, W) int32 (0 = background)."""
    h, w = mask.shape
    fg = mask.bool()
    big = h * w
    idx = torch.arange(h * w, device=mask.device, dtype=torch.float32).reshape(h, w)
    # min over the 8-neighbourhood as a max-pool of the negated labels;
    # float32 holds pixel indices exactly up to 2^24 pixels
    if big >= 1 << 24:
        raise ValueError(f"connected_components takes masks under 2^24 pixels, got {h}x{w}")
    lbl = torch.where(fg, idx, float(big))
    for _ in range(max_iters):
        pooled = -F.max_pool2d(-lbl[None, None], 3, stride=1, padding=1)[0, 0]
        new = torch.where(fg, pooled, float(big))
        if torch.equal(new, lbl):
            break
        lbl = new
    return torch.where(fg, lbl + 1, 0.0).to(torch.int32)


def component_areas(labels):
    """labels (H, W) int32 (0 = background) -> areas (H * W + 1,) int32,
    areas[l] the pixel count of label l (index 0 collects the background)."""
    n = labels.shape[0] * labels.shape[1]
    return torch.bincount(labels.reshape(-1).long(), minlength=n + 1).to(torch.int32)


def fill_holes_in_mask_scores(mask_scores, max_hole_area: float, remove_sprinkles: bool = False):
    """Fill small negative-score holes of (H, W) mask logits with +0.1:
    background components (score <= 0) of at most max_hole_area pixels count
    as foreground. With remove_sprinkles, foreground components of the
    patched map of at most min(total foreground // 2, max_hole_area) pixels
    are then set to -0.1."""
    labels = connected_components(mask_scores <= 0).long()
    pix_area = component_areas(labels)[labels]
    is_hole = (labels > 0) & (pix_area <= max_hole_area)
    patched = torch.where(is_hole, 0.1, mask_scores)
    if remove_sprinkles:
        fg = patched > 0
        fg_labels = connected_components(fg).long()
        fg_area = component_areas(fg_labels)[fg_labels]
        thresh = min(int(fg.sum()) // 2, int(max_hole_area))
        patched = torch.where((fg_labels > 0) & (fg_area <= thresh), -0.1, patched)
    return patched


def _fill_holes_scipy(flat, max_hole_area, remove_sprinkles):
    from scipy import ndimage

    eight = np.ones((3, 3), int)
    for sl in flat:
        labels, n = ndimage.label(sl <= 0, structure=eight)
        if n > 0:
            areas = np.bincount(labels.ravel(), minlength=n + 1)
            areas[0] = 0
            pix = areas[labels]
            sl[(pix > 0) & (pix <= max_hole_area)] = 0.1
        if remove_sprinkles:
            fg = sl > 0
            labels, n = ndimage.label(fg, structure=eight)
            if n == 0:
                continue
            thresh = min(int(fg.sum()) // 2, int(max_hole_area))
            areas = np.bincount(labels.ravel(), minlength=n + 1)
            areas[0] = 0
            pix = areas[labels]
            sl[(pix > 0) & (pix <= thresh)] = -0.1


def fill_holes_in_mask_scores_host(mask_scores, max_hole_area: float,
                                   remove_sprinkles: bool = False, native: bool = True):
    """``fill_holes_in_mask_scores`` on the host over (..., H, W) float
    arrays, for the video pipeline's emission path (host numpy anyway).
    Returns a patched float32 copy.

    native=True (the card's path) runs the host C++ run-based union-find
    (``native.fill_holes``, threaded over masks) and raises if the library
    cannot be built; native=False runs scipy.ndimage.label per mask, which
    the CPU tests take. The two agree exactly."""
    out = np.ascontiguousarray(np.array(mask_scores, np.float32, copy=True))
    if out.ndim < 2:
        raise ValueError(f"mask scores need (..., H, W), got {out.shape}")
    if native:
        from efficientsam3_tpu_torch import native as host

        host.fill_holes(out, float(max_hole_area), 0.1, remove_sprinkles=remove_sprinkles)
    else:
        _fill_holes_scipy(out.reshape(-1, *out.shape[-2:]), max_hole_area, remove_sprinkles)
    return out
