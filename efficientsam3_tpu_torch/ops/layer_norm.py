"""Row LayerNorm forward: a Triton kernel for CUDA, its plain version for CPU.

Replaces the Pallas kernel ``efficientsam3_tpu/ops/pallas/layer_norm.py``
(``_fwd_call`` / ``_fwd_kernel``): y = (x - mean) / sqrt(var + eps) * w + b
over the last axis, fp32 statistics, biased (two-pass) variance, eps inside
the sqrt, output in the dtype the caller asks for (bf16 on the grounding
path, so the consumer projections read half the bytes).

On the H100 this is bound by bytes: one read of x and one write of y per
row, ~5 flops per element. The kernel keeps each 256-channel row in
registers (one program per row, statistics and normalisation in one pass
over the loaded row), so x is read once and nothing but y is written. The
``layer_norm`` wrapper counts its kernel launches in ``layer_norm.launches``.
"""

from __future__ import annotations

import functools
import os

import torch

from efficientsam3_tpu_torch.ops._build import BUILD_DIR


def layer_norm_plain(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """The kernel's arithmetic in plain PyTorch (fp32 statistics)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    # keep Triton's compile cache with the other build outputs, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(X, W, B, Y, n_cols, stride_x, stride_y, eps,
                BLOCK: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inb = cols < n_cols
        x = tl.load(X + row * stride_x + cols, mask=inb, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(inb, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=inb, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=inb, other=0.0).to(tl.float32)
        y = xc * rstd * w + b
        tl.store(Y + row * stride_y + cols, y.to(Y.dtype.element_ty), mask=inb)

    return triton, _ln_fwd


def _launch(x2, weight, bias, eps, out_dtype):
    triton, kernel = _triton_kernel()
    rows, c = x2.shape
    y = torch.empty((rows, c), dtype=out_dtype, device=x2.device)
    block = triton.next_power_of_2(c)
    kernel[(rows,)](
        x2, weight, bias, y, c, x2.stride(0), y.stride(0), float(eps),
        BLOCK=block, num_warps=max(1, min(8, block // 256)),
    )
    return y


def layer_norm(x, weight, bias, eps: float = 1e-5, out_dtype=None):
    """LayerNorm over the last axis of x (any leading rank).

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (x in fp32 or bf16, output in ``out_dtype``, default x.dtype).
    """
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps, out_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel writes float32 or bfloat16, got {out_dtype}")
    c = x.shape[-1]
    if c > 8192:
        raise ValueError(f"layer_norm kernel keeps one row in registers; {c} channels is too wide")
    x2 = x.reshape(-1, c)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    with torch.cuda.device(x.device):  # Triton launches on the current device
        y = _launch(x2, w, b, eps, out_dtype)
    layer_norm.launches += 1
    return y.reshape(x.shape)


layer_norm.launches = 0
