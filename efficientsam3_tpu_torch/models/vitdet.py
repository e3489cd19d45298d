"""SAM3 teacher trunk (ViTDet ViT-H), NHWC; also the SAM1 ViT students'.

Counterpart of efficientsam3_tpu/models/vitdet.py: patch embedding 14x14
with stride 14 and no bias (72x72 tokens at 1008^2), the absolute position
embedding of the 24x24 pretraining grid (its cls slot dropped) tiled over
the token grid, ``ln_pre``, then 32 pre-LN blocks, width 1024, 16 heads of
64, MLP 4.625x (4736 wide, exact GELU), window 24 with global attention at
blocks (7, 15, 23, 31), and axial 2D RoPE on q and k interpolated to the
24-token pretraining grid (the JAX ``axial_rope_cos_sin`` and
``apply_rope_pairs`` are ``common.compute_axial_rope_cos_sin`` with its
``scale_pos`` and ``common.apply_rope``).

Windowed blocks attend 9 windows of 576 tokens on the matmul path; the
global blocks' (1, 16, 5184, 64) attention passes ``common.sdpa``'s
threshold and runs on the ``flash_sdpa`` kernel at d=64 on CUDA. The norms
are the port's plain ``LayerNorm`` (flax ``nn.LayerNorm``: fp32 out), so
the residual stream stays fp32 under a bf16 ``dtype``, as in JAX.

The SAM1 ViT students (``student_sam.build_sam_vit_student``) build the
same trunk with patch 16, window 14, a 64x64 pretraining grid and MLP 4.0:
768 / 12, 1024 / 16 and 1280 / 16 (head dims 64, 64 and 80; at d=80 the
RoPE tables hold 20 frequencies a quarter). At 1024^2 their 64x64 token
grid does not split into 14-token windows and a windowed block raises, as
the JAX block asserts; at 1120^2 (70x70 tokens, 5x5 windows of 196 tokens)
they run, the global blocks' (1, H, 4900, d) attention on ``flash_sdpa``.

Training mode follows the JAX trunk's: DropPath after the attention and
after the MLP of block i at ``drop_path_rate * i / max(depth - 1, 1)``
(``common.DropPath``: its masks come from the ``generator`` passed to
``forward``, and without one a nonzero rate raises, as flax does without a
"dropout" rng), and each block checkpointed (``torch.utils.checkpoint``,
non-reentrant: flax's per-block ``nn.remat``), so the backward recomputes
a block's activations from its input. Checkpointing restores only the
default generators, so a block's two DropPath masks are drawn before the
checkpointed call and passed in: the recompute drops the same samples.
The recompute runs under grad mode, so a global block launches the
``flash_sdpa`` forward twice a training step and the d=64 / d=80 dq and
dkv kernels once each; the windowed blocks' attention stays on the
matmul path and autograd differentiates it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from efficientsam3_tpu_torch.models.common import (
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    apply_rope,
    compute_axial_rope_cos_sin,
    gelu_exact,
    sdpa,
)

ROPE_PT_SIZE = 24  # the RoPE pretraining grid, fixed in JAX's ViTAttention


def axial_rope_cos_sin(head_dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                       scale_pos: float = 1.0, device=None):
    """(cos, sin) tables of an end_x x end_y grid, each (end_x * end_y,
    head_dim // 2), positions scaled by ``scale_pos`` (reference
    sam3/sam3/sam/rope.py:24 with interpolation scaling)."""
    return compute_axial_rope_cos_sin(head_dim, end_x, end_y, theta, device, scale_pos)


def apply_rope_pairs(x, cos, sin):
    """Rotate adjacent pairs of x's last axis (torch view_as_complex layout)."""
    return apply_rope(x, cos, sin)


@functools.lru_cache(maxsize=None)
def _rope_tables(head_dim: int, grid: int, scale_pos: float, device: torch.device):
    """The tables of a (grid x grid) attention, built once per head dim,
    grid, scale and device (plain tensors even under inference mode)."""
    with torch.inference_mode(False):
        return compute_axial_rope_cos_sin(head_dim, grid, grid, 10000.0, device, scale_pos)


class ViTAttention(nn.Module):
    """Packed-qkv attention with axial RoPE over a square token grid.

    The RoPE positions are scaled by ``ROPE_PT_SIZE / grid`` (grid = the
    input's side: the window in windowed blocks, the whole map in global
    ones), as in JAX, where the trunk's ``pretrain_grid`` does not reach
    it."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        """x (B, S, S, C) -> same."""
        b, h, w, _ = x.shape
        if h != w:
            raise ValueError(f"ViTAttention takes a square grid, got {h}x{w}")
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # v stays a strided view: the kernel reads it in place
        cos, sin = _rope_tables(hd, h, ROPE_PT_SIZE / h, x.device)
        out = sdpa(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, self.dim))


class ViTBlock(nn.Module):
    """Pre-LN block: (windowed or global) attention + MLP, each branch
    through DropPath (the keep masks ``mask1``, ``mask2`` of
    ``drop_masks``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 drop_path: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = window_size  # 0 = global
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim, 1e-5)
        self.attn = ViTAttention(dim, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, 1e-5)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def drop_masks(self, x, generator: Optional[torch.Generator]):
        """The keep masks of the two branches for x's batch, or (None, None)
        when DropPath is the identity (eval mode, rate 0)."""
        if not self.drop_path.active():
            return None, None
        return self.drop_path.mask(x, generator), self.drop_path.mask(x, generator)

    def forward(self, x, mask1=None, mask2=None):
        b, h, w, c = x.shape
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            if h % ws or w % ws:
                raise ValueError(f"a {h}x{w} token grid does not split into {ws}x{ws} windows")
            nh, nw = h // ws, w // ws
            xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
            xw = self.attn(xw.reshape(b * nh * nw, ws, ws, c))
            x = xw.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        else:
            x = self.attn(x)
        x = shortcut + self.drop_path(x, mask=mask1)
        y = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path(y, mask=mask2)


class ViTTrunk(nn.Module):
    """images (B, H, W, 3) -> (B, H/14, W/14, embed_dim) final feature map."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024, depth: int = 32,
                 num_heads: int = 16, mlp_ratio: float = 4.625, window_size: int = 24,
                 global_att_blocks: Sequence[int] = (7, 15, 23, 31), pretrain_grid: int = 24,
                 drop_path_rate: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = self.out_channels = embed_dim
        self.pretrain_grid = pretrain_grid
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size, bias=False,
                                dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty(pretrain_grid * pretrain_grid + 1, embed_dim))
        self.ln_pre = LayerNorm(embed_dim, 1e-5)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in global_att_blocks else window_size,
                     drop_path_rate * i / max(depth - 1, 1), dtype=dtype)
            for i in range(depth))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the DropPath masks in training mode (needed
        at a nonzero ``drop_path_rate``)."""
        if x.shape[1] % self.patch_size or x.shape[2] % self.patch_size:
            raise ValueError(f"image sides {tuple(x.shape[1:3])} are not multiples of the "
                             f"{self.patch_size}-pixel patch")
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        pg = self.pretrain_grid
        grid_pos = self.pos_embed[1:].reshape(pg, pg, -1)
        if (h, w) != (pg, pg):
            grid_pos = grid_pos.repeat(-(-h // pg), -(-w // pg), 1)[:h, :w]
        x = self.ln_pre(x + grid_pos[None])
        remat = self.training and torch.is_grad_enabled()
        for blk in self.blocks:
            masks = blk.drop_masks(x, generator)
            x = checkpoint(blk, x, *masks, use_reentrant=False) if remat else blk(x, *masks)
        return x
