"""Gathers whose backward adds without atomics.

On CUDA, the backward of ``torch.gather`` is a ``scatter_add`` by atomics:
where two gathered elements come from one source element, their gradients
meet in whatever order the threads reach it, and two runs of the same step
give other bits. The gathers here return the same values, and their
backward sums the gradients of each source element in a fixed order: a
stable sort of the indices, then a segment sum over each run of equal
indices (``index_sum``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def index_sum(n: int, idx, values):
    """(n, *values.shape[1:]) in values.dtype: row r is the sum of the rows
    values[i] with idx[i] == r, added in the order of i (in fp32); rows
    that no index names are 0."""
    if idx.numel() == 0:
        return values.new_zeros((n, *values.shape[1:]))
    order = torch.argsort(idx, stable=True)
    keys, counts = torch.unique_consecutive(idx[order], return_counts=True)
    sums = torch.segment_reduce(values[order].float(), "sum", lengths=counts, axis=0)
    out = values.new_zeros((n, *values.shape[1:]))
    out[keys] = sums.to(values.dtype)  # each key once: no two writes meet
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return index_sum(ctx.rows, idx, g), None


class _TakeColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.cols = x.shape[2]
        return torch.gather(x, 2, idx[:, None].expand(-1, x.shape[1], -1))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        n, c, p = g.shape
        flat = (idx + torch.arange(n, device=idx.device)[:, None] * ctx.cols).reshape(-1)
        rows = index_sum(n * ctx.cols, flat, g.transpose(1, 2).reshape(n * p, c))
        return rows.reshape(n, ctx.cols, c).transpose(1, 2), None


def take_rows(x, idx):
    """x[idx] for a 1-d index over x's first axis."""
    return _TakeRows.apply(x, idx)


def take_columns(x, idx):
    """x (N, C, L) at idx (N, P) along L, the same index for every channel
    -> (N, C, P): torch.gather(x, 2, idx expanded over C)."""
    return _TakeColumns.apply(x, idx)
