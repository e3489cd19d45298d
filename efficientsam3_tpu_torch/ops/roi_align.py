"""``roi_align`` on the JAX package's static sample grid.

Counterpart of efficientsam3_tpu/ops/roi_align.py with the settings the
geometry encoder uses (adaptive sampling_ratio=-1, aligned=False): each
output bin averages ratio_h * ratio_w bilinear samples, ratio = ceil(bin
size) per ROI, laid over a fixed ``MAX_SAMPLING_RATIO`` grid with
(k < ratio) / ratio weights. The sampling is separable per axis, so each
ROI's pooling is two small products ``Ry @ F @ Rx^T``. This follows the
JAX grid exactly (not torchvision's, which the JAX port documents as
within 1e-2). The ROIs' feature maps are gathered by
``ops/gather.take_rows``, whose backward adds without atomics.
"""

from __future__ import annotations

import torch

from efficientsam3_tpu_torch.ops.gather import take_rows

# static cap of the adaptive sample grid: ratio <= ceil(72 / 7) = 11 at the
# 72x72 token map and roi_size 7, so 16 samples per bin per axis suffice
MAX_SAMPLING_RATIO = 16


def roi_align(features, boxes, batch_indices, output_size):
    """features (N, C, H, W); boxes (R, 4) xyxy in feature-map pixels;
    batch_indices (R,) -> (R, C, out_h, out_w)."""
    n, c, h, w = features.shape
    out_h, out_w = output_size
    dev = features.device
    boxes = boxes.float()
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = (boxes[:, 2] - x1).clamp_min(1.0)
    roi_h = (boxes[:, 3] - y1).clamp_min(1.0)
    bin_w = roi_w / out_w
    bin_h = roi_h / out_h
    s = MAX_SAMPLING_RATIO
    r_h = torch.ceil(bin_h).clamp(1.0, s)
    r_w = torch.ceil(bin_w).clamp(1.0, s)

    iy = torch.arange(out_h * s, dtype=torch.float32, device=dev)
    ix = torch.arange(out_w * s, dtype=torch.float32, device=dev)
    by, ky = torch.div(iy, s, rounding_mode="floor"), torch.remainder(iy, s)
    bx, kx = torch.div(ix, s, rounding_mode="floor"), torch.remainder(ix, s)
    sy = y1[:, None] + (by[None, :] + (ky[None, :] + 0.5) / r_h[:, None]) * bin_h[:, None]
    sx = x1[:, None] + (bx[None, :] + (kx[None, :] + 0.5) / r_w[:, None]) * bin_w[:, None]
    wy = torch.where(ky[None, :] < r_h[:, None], 1.0 / r_h[:, None], torch.zeros_like(sy))
    wx = torch.where(kx[None, :] < r_w[:, None], 1.0 / r_w[:, None], torch.zeros_like(sx))

    def axis_weights(coord, valid, wgt, size, out_size):
        """(R, out_size*s) -> (R, out_size, size)."""
        cc = coord.clamp(0.0, size - 1)
        c0 = torch.floor(cc)
        frac = cc - c0
        c0i = c0.long()
        c1i = (c0i + 1).clamp_max(size - 1)
        idx = torch.arange(size, device=dev)
        a = (1.0 - frac)[:, :, None] * (idx[None, None] == c0i[:, :, None]) \
            + frac[:, :, None] * (idx[None, None] == c1i[:, :, None])
        a = a * (wgt * valid.to(wgt.dtype))[:, :, None]
        return a.reshape(a.shape[0], out_size, s, size).sum(2)

    ry = axis_weights(sy, (sy >= -1.0) & (sy <= h), wy, h, out_h)
    rx = axis_weights(sx, (sx >= -1.0) & (sx <= w), wx, w, out_w)
    feats = take_rows(features, batch_indices).float()
    rows = torch.einsum("rbi,rcij->rcbj", ry, feats)
    out = torch.einsum("rcbj,rxj->rcbx", rows, rx)
    return out.to(features.dtype)
