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
    """HWC float image -> (out_h, out_w, C) fp32, the resize of
    jax.image.resize(..., "linear", antialias=True): a triangle filter
    widened by the downscale factor. F.interpolate's antialiased bilinear
    computes the same weights (held against JAX in tests/test_torch_ops.py)."""
    x = img.float().permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)
