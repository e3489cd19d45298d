"""Exact Euclidean distance transform as tensor operations.

Counterpart of efficientsam3_tpu/ops/edt.py: distance from each nonzero
pixel to the nearest zero pixel (scipy.ndimage.distance_transform_edt
semantics), used to place correction clicks far from the boundary of a mask
error. Two passes, as there: the distance in steps to the nearest zero
within each row (the JAX package scans; here a running maximum of the zero
positions from each side), then D^2[i, c] = min_r ((i - r)^2 + rowdist[r,
c]^2) as a chunked min-plus reduction over r. A map with no zero pixel gives
sqrt(1e9) everywhere, as the JAX version does. The host path of
``video/click_sampling`` takes ``native.edt`` instead.
"""

from __future__ import annotations

import torch

_BIG = 1e9


def _row_distance(mask):
    """mask (H, W) bool (True = foreground): steps to the nearest background
    pixel within the row (_BIG where the row has none)."""
    h, w = mask.shape
    idx = torch.arange(w, dtype=torch.float32, device=mask.device).expand(h, w)
    zero_at = torch.where(mask, -_BIG, idx)  # positions of zeros, else far left
    fwd = idx - torch.cummax(zero_at, dim=1).values
    zero_rev = torch.where(mask, -_BIG, (w - 1) - idx).flip(1)
    bwd = (idx - torch.cummax(zero_rev, dim=1).values).flip(1)
    return torch.minimum(fwd, bwd).clamp_max(_BIG)


def edt(mask, chunk: int = 128):
    """mask (H, W) bool/int -> (H, W) float32 Euclidean distances."""
    mask = mask.bool()
    h, w = mask.shape
    g = _row_distance(mask)
    g2 = (g * g).clamp_max(_BIG)
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)
    best = torch.full((h, w), _BIG, dtype=torch.float32, device=mask.device)
    for r0 in range(0, h, chunk):
        diff = rows[:, None] - rows[None, r0:r0 + chunk]  # (H, chunk)
        cand = (diff * diff)[:, :, None] + g2[None, r0:r0 + chunk, :]
        best = torch.minimum(best, cand.amin(dim=1))
    d = torch.sqrt(best.clamp_max(_BIG))
    return torch.where(mask, d, 0.0)


def edt_batch(masks, chunk: int = 128):
    """(B, H, W) -> (B, H, W)."""
    return torch.stack([edt(m, chunk) for m in masks])
