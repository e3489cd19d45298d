"""Image resizes of the port, computed in fp32.

Counterpart of efficientsam3_tpu/ops/interpolate.py, whose matmul
formulation reproduces torch's ``F.interpolate`` bilinear conventions
(half-pixel centres, negative-side clamp for align_corners=False, no
antialiasing); the port calls ``F.interpolate`` itself.
``resize_antialiased`` matches ``jax.image.resize(..., "linear",
antialias=True)``, which the JAX processor applies to its input image.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size):
    """Bilinear resize of an (N, C, H, W) tensor, torch semantics
    (align_corners=False), computed in fp32 and returned in x.dtype."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=False)
    return y.to(x.dtype)


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
