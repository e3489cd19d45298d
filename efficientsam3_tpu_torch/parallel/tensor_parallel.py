"""Tensor parallelism for the SAM3 detector over a 'tp' mesh axis.

Counterpart of efficientsam3_tpu/parallel/tensor_parallel.py. The JAX
package puts Megatron-style PartitionSpecs on the fusion encoder's and the
decoder's weights and lets GSPMD insert the collectives; the port applies
the same rule by hand. Column-parallel layers (q/k/v projections, the
FFN's linear1) keep their rank's slice of the output features, so each
attention keeps ``num_heads / tp`` heads of the same head dim; row-parallel
layers (out_proj, linear2) keep their rank's slice of the input features,
and their partial outputs are summed over the 'tp' group, the bias added
once after the sum. A column layer's input gradient is summed over the
group in the backward (Megatron's copy-to-region), a row layer's output
gradient passes through (its reduce-from-region), so the replicated
parameters get the unsharded model's gradients on every rank.

A torch ``Linear`` weight is (out, in), the transpose of flax's kernel:
a column layer shards the weight's dim 0 and its bias, a row layer the
weight's dim 1 (its bias stays whole). Everything else (norms,
embeddings, convs, the trunk and the heads) stays replicated. The
decoder's boxRPB bias is built whole on every rank; each attention takes
its heads' slice of it, whose gradient is summed over the group in the
backward like a column layer's input.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficientsam3_tpu_torch.models.common import Dense, MultiheadAttention, _cdtype

# the detector's two 8-head transformer loops (the tracker's memory
# attention is single-head and scales over 'objects' / 'frames' instead)
TP_SCOPES = ("fusion_encoder", "decoder")
_COLUMN = ("q_proj", "k_proj", "v_proj", "linear1")
_ROW = ("out_proj", "linear2")


def tp_param_spec(model_or_state_dict, tp_axis: str = "tp", scopes=TP_SCOPES) -> dict:
    """{parameter name: spec}: the tuple of one mesh axis name or None per
    dim, ``()`` for a replicated leaf, under the Megatron column / row rule
    inside ``scopes``. Takes a module (its parameters; a ``meta`` build
    will do) or a state_dict."""
    if isinstance(model_or_state_dict, torch.nn.Module):
        items = model_or_state_dict.named_parameters()
    else:
        items = model_or_state_dict.items()

    def rule(name, ndim):
        names = name.split(".")
        if names[0] not in scopes or ndim == 0 or len(names) < 2:
            return ()
        kind, owner = names[-1], names[-2]
        if owner in _COLUMN:
            if kind == "weight" and ndim == 2:
                return (tp_axis, None)
            if kind == "bias" and ndim == 1:
                return (tp_axis,)
        if owner in _ROW and kind == "weight" and ndim == 2:
            return (None, tp_axis)
        return ()

    return {k: rule(k, len(v.shape)) for k, v in items}


def count_sharded(spec: Mapping) -> int:
    """Number of leaves with a non-trivial spec (a sanity metric)."""
    return sum(1 for s in spec.values() if any(a is not None for a in s))


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x, group):
    """x as it is; in the backward its gradient summed over the group (a
    replicated tensor of which each rank uses its own part)."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelDense(Dense):
    """A Dense holding its rank's slice of the output features."""

    def forward(self, x):
        return super().forward(copy_to_group(x, self.tp_group))


class TensorParallelAttention(MultiheadAttention):
    """A MultiheadAttention holding ``num_heads`` of the heads, from
    ``head_offset`` on: its column-sharded projections' heads. The
    decoder's boxRPB tables come whole; it takes its heads' slice of them,
    whose gradient is summed over the group in the backward."""

    def forward(self, q, k, v, key_padding_mask=None, rpb=None, attn_mask=None):
        if rpb is not None:
            ey, ex, feat_hw = rpb
            heads = slice(self.head_offset, self.head_offset + self.num_heads)
            ey, ex = (copy_to_group(e, self.tp_group)[:, heads].contiguous() for e in (ey, ex))
            rpb = (ey, ex, feat_hw)
        return super().forward(q, k, v, key_padding_mask, rpb, attn_mask)


class RowParallelDense(Dense):
    """A Dense holding its rank's slice of the input features: the partial
    products are summed over the group, then the whole bias is added."""

    def forward(self, x):
        dt = _cdtype(x, self.dtype)
        y = _ReduceFromGroup.apply(F.linear(x.to(dt), self.weight.to(dt)), self.tp_group)
        return y if self.bias is None else y + self.bias.to(dt)


def shard_params(model: torch.nn.Module, mesh, spec=None, tp_axis: str = "tp"):
    """Turn ``model``'s in-scope layers into this rank's shard of them, in
    place, under ``spec`` (``tp_param_spec(model)`` by default), and
    return the model. Each attention with column-sharded projections
    becomes a ``TensorParallelAttention`` of ``num_heads / tp`` heads, from
    head ``rank * num_heads / tp`` on."""
    spec = tp_param_spec(model, tp_axis) if spec is None else spec
    group = mesh.get_group(tp_axis)
    n = mesh.size(mesh.mesh_dim_names.index(tp_axis))
    r = mesh.get_local_rank(tp_axis)

    def cut(p, dim):
        size = p.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide over tp={n}")
        k = size // n
        return torch.nn.Parameter(p.detach().narrow(dim, r * k, k).clone(),
                                  requires_grad=p.requires_grad)

    for name, m in model.named_modules():
        if type(m) is MultiheadAttention and spec.get(f"{name}.q_proj.weight") == (
                tp_axis, None):
            if m.num_heads % n:
                raise ValueError(f"{name}: {m.num_heads} heads do not divide over tp={n}")
            m.num_heads //= n
            m.head_offset = r * m.num_heads
            m.tp_group = group
            m.__class__ = TensorParallelAttention
        if type(m) is not Dense:
            continue
        s = spec.get(f"{name}.weight", ())
        if s == (tp_axis, None):
            m.weight = cut(m.weight, 0)
            if m.bias is not None:
                m.bias = cut(m.bias, 0)
            m.__class__ = ColumnParallelDense
        elif s == (None, tp_axis):
            m.weight = cut(m.weight, 1)
            m.__class__ = RowParallelDense
        else:
            continue
        m.tp_group = group
    return model
