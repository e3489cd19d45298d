"""Image resizes of the port, computed in fp32.

Counterpart of efficientsam3_tpu/ops/interpolate.py, whose matmul
formulation reproduces torch's ``F.interpolate`` bilinear conventions
(half-pixel centres, negative-side clamp for align_corners=False, no
antialiasing); the port calls ``F.interpolate`` itself.
``resize_antialiased`` matches ``jax.image.resize(..., "linear",
antialias=True)``, which the JAX processor applies to its input image.
``resize`` dispatches by mode, as the JAX one does: bilinear and bicubic
(Keys a = -0.75, torch's) through ``F.interpolate``, nearest with JAX's
integer source index floor(i * in / out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _over_last_two(x, size, mode, align_corners):
    """F.interpolate over the trailing (H, W) axes of any leading shape,
    computed in fp32 and returned in x.dtype."""
    lead = x.shape[:-2]
    y = F.interpolate(x.float().reshape(-1, 1, *x.shape[-2:]), size=tuple(size), mode=mode,
                      align_corners=align_corners)
    return y.reshape(*lead, *y.shape[-2:]).to(x.dtype)


def resize_bilinear(x, size, align_corners: bool = False):
    """Bilinear resize over the trailing (H, W) axes (an (N, C, H, W)
    tensor), torch semantics, computed in fp32 and returned in x.dtype."""
    if x.ndim == 4:
        y = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                          align_corners=align_corners)
        return y.to(x.dtype)
    return _over_last_two(x, size, "bilinear", align_corners)


def resize_bicubic(x, size, align_corners: bool = False):
    """Bicubic resize over the trailing (H, W) axes, torch semantics."""
    return _over_last_two(x, size, "bicubic", align_corners)


def resize_nearest(x, size):
    """Nearest-neighbour resize over the trailing (H, W) axes: source index
    floor(i * in / out) in integers, as the JAX package computes it."""
    out_h, out_w = size
    in_h, in_w = x.shape[-2], x.shape[-1]
    ih = (torch.arange(out_h, device=x.device) * in_h // out_h).clamp_max(in_h - 1)
    iw = (torch.arange(out_w, device=x.device) * in_w // out_w).clamp_max(in_w - 1)
    return x[..., ih, :][..., iw]


def resize(x, size, mode: str = "bilinear", align_corners: bool = False):
    if mode == "bilinear":
        return resize_bilinear(x, size, align_corners)
    if mode == "bicubic":
        return resize_bicubic(x, size, align_corners)
    if mode == "nearest":
        return resize_nearest(x, size)
    raise ValueError(f"unsupported resize mode: {mode}")


def resize_antialiased(img, size):
    """HWC image, or NHWC maps, -> (..., out_h, out_w, C) fp32: the resize
    of jax.image.resize(..., "linear") over the two spatial axes, which is
    antialiased by default: a triangle filter widened by the downscale
    factor (upscaling: plain half-pixel bilinear, edge weights
    renormalised). F.interpolate's antialiased bilinear computes the same
    weights (held against JAX in tests/test_torch_ops.py and, for NHWC
    maps in both directions, tests/test_torch_sam1_slice.py)."""
    x = img.float()
    x = x.permute(2, 0, 1)[None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    y = y.permute(0, 2, 3, 1)
    return y[0] if img.ndim == 3 else y
