"""Torch-semantics bilinear ``grid_sample`` (2D), with gathers.

Counterpart of efficientsam3_tpu/ops/grid_sample.py, written out the same
way (four corner gathers) so both packages sample the same grid, with the
settings the geometry encoder uses: mode='bilinear', padding_mode='zeros',
align_corners=False, NCHW input, grid (N, Hg, Wg, 2) in [-1, 1] xy. The
gathers' backward adds without atomics (``ops/gather.take_columns``).
"""

from __future__ import annotations

import torch

from efficientsam3_tpu_torch.ops.gather import take_columns


def grid_sample(x, grid):
    """Sample x (N, C, H, W) at grid (N, Hg, Wg, 2) -> (N, C, Hg, Wg);
    samples outside the map read zero."""
    n, c, h, w = x.shape
    gx = ((grid[..., 0].float() + 1.0) * w - 1.0) / 2.0
    gy = ((grid[..., 1].float() + 1.0) * h - 1.0) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = x.reshape(n, c, h * w)

    def gather(ix, iy):
        valid = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)).to(x.dtype)
        ixc = ix.clamp(0, w - 1).long()
        iyc = iy.clamp(0, h - 1).long()
        out = take_columns(flat, (iyc * w + ixc).reshape(n, -1))
        return out.reshape(n, c, *ix.shape[1:]) * valid[:, None]

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    wx = wx[:, None]
    wy = wy[:, None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)
