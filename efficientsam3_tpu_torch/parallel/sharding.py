"""Meshes and sharding strategies on torch.distributed.

Counterpart of efficientsam3_tpu/parallel/sharding.py. The JAX package
hands shardings to XLA, which partitions one program over the mesh; here
every rank runs its own process, so each strategy says what a rank
computes and which collective joins the ranks:

  P1 (data-parallel training)   -> ``train/trainer.Trainer(mesh=...)``:
                                   parameters broadcast once from the
                                   axis's first rank (``replicate``), each
                                   rank takes its slice of every batch
                                   (``shard_batch``), gradients averaged
                                   over the 'dp' group before the step's
                                   grad norm, BatchNorm statistics reduced
                                   over it (``data_parallel``).
  P2 (frame-parallel detection) -> ``frame_parallel``: each rank runs the
                                   frames-batched function on its slice of
                                   the frames, the outputs are all-gathered
                                   along axis 0.
  P3 (object-parallel tracking) -> ``object_parallel``: the same over the
                                   tracker's object slots; the host-side
                                   plan runs on every rank over the
                                   gathered outputs.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the axis names; ``make_mesh`` needs an initialised process group
(``parallel.launch.initialize_distributed``, or ``dist.init_process_group``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(axis_sizes: dict, device_type: Optional[str] = None):
    """A mesh over the first prod(sizes) ranks of the default group, e.g.
    ``make_mesh({'dp': 2, 'tp': 2})``. ``device_type``: 'cuda' under NCCL,
    'cpu' otherwise, unless given."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize_distributed or dist.init_process_group")
    total = math.prod(axis_sizes.values())
    world = dist.get_world_size()
    if total > world:
        raise ValueError(f"need {total} devices, have {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    ranks = torch.arange(total).reshape(tuple(axis_sizes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_sizes))


def _axis(mesh, axis: Optional[str]) -> str:
    if axis is not None:
        return axis
    if mesh.ndim != 1:
        raise ValueError(f"name the axis of a {mesh.ndim}-d mesh {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names[0]


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def replicate(mesh, axis: Optional[str] = None):
    """The placement of replicated state: a function that broadcasts a
    module's parameters and buffers (or a tensor, or a list of them) in
    place from the first rank of ``axis`` (a 1-d mesh's only axis by
    default) to the rest of it, and returns its argument."""
    axis = _axis(mesh, axis)

    def place(obj):
        group = mesh.get_group(axis)
        if isinstance(obj, torch.nn.Module):
            tensors = [t.data for t in obj.parameters()] + list(obj.buffers())
        elif isinstance(obj, torch.Tensor):
            tensors = [obj]
        else:
            tensors = list(obj)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src, group=group)
        return obj

    return place


def _map(tree, fn):
    """fn over every tensor and numpy array of dicts, lists, tuples and
    dataclasses; other leaves as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def _local_slice(tree, index: int, count: int):
    def cut(x):
        n = x.shape[0]
        if n % count:
            raise ValueError(f"leading axis {n} does not divide over {count} ranks")
        k = n // count
        return x[index * k:(index + 1) * k]

    return _map(tree, cut)


def shard_batch(mesh, axis: str = "dp"):
    """The placement of a batch: a function that gives this rank its slice
    of the leading axis of every tensor and numpy array in a batch (dicts,
    lists, tuples and dataclasses such as ``Prompt`` walked), which must
    divide by the axis's size."""

    def place(tree):
        return _local_slice(tree, mesh.get_local_rank(axis), _size(mesh, axis))

    return place


def _gather_leading(tree, group, count: int):
    """Every tensor of ``tree`` all-gathered along axis 0 over ``group``,
    in rank order."""
    if count == 1:
        return tree

    def gather(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(count)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    return _map(tree, gather)


def frame_parallel(fn, mesh, axis: str = "frames"):
    """``fn(frames, *args)`` with ``frames``' leading axis split over the
    mesh axis: each rank runs its slice, and every output tensor is
    all-gathered along axis 0, so each rank holds the whole result (what
    the JAX package's sharded output holds logically)."""
    return object_parallel(fn, mesh, axis, n_array_args=1)


def object_parallel(fn, mesh, axis: str = "objects", n_array_args: int = 1):
    """``fn(*args)`` whose first ``n_array_args`` arguments (tensors, or
    tuples / dicts of them) carry object slots on their leading axis: each
    rank runs its slice of the slots, the other arguments as they are, and
    every output tensor is all-gathered along axis 0."""

    def run(*args, **kwargs):
        count = _size(mesh, axis)
        index = mesh.get_local_rank(axis)
        local = _local_slice(tuple(args[:n_array_args]), index, count)
        out = fn(*local, *args[n_array_args:], **kwargs)
        return _gather_leading(out, mesh.get_group(axis), count)

    return run


# --------------------------------------------------------------------------
# differentiable collectives and the data-parallel group
# --------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the gradient is summed over it too (each rank's
    loss is one term of the world's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


def all_reduce_sum(x, group):
    """Differentiable all-reduce (sum) whose backward all-reduces the
    gradient: the cross-rank BatchNorm statistics."""
    return _AllReduce.apply(x, group)


_DP_GROUP = contextvars.ContextVar("data_parallel_group", default=None)


def data_parallel_group():
    """The data-parallel group of the step in flight (None outside
    ``data_parallel``)."""
    return _DP_GROUP.get()


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, BatchNorm statistics in training mode and the
    Stage-3 loss's box count are reduced over ``group``."""
    token = _DP_GROUP.set(group)
    try:
        yield group
    finally:
        _DP_GROUP.reset(token)
