"""Carry weights over from the JAX package's variables to the port.

``convert_variables`` turns flax ``variables`` (``params`` and
``batch_stats``, a nested mapping of arrays) into the port's
``state_dict`` by a rule-based walk, since the port's parameter names
follow the flax tree:

  - a module name ``name_<i>`` becomes ``name.<i>`` (flax ``layers_3`` is
    the ModuleList entry ``layers.3``); other names are kept;
  - Dense ``kernel`` (in, out) -> ``weight`` (out, in);
  - Conv ``kernel`` (kh, kw, in/g, out) -> ``weight`` (out, in/g, kh, kw);
  - ``scale`` and ``embedding`` -> ``weight``;
  - BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

The tracker's tree (``init_tracker_variables``) converts by the same
rules: its raw parameters (``maskmem_tpos_enc``, ``no_mem_embed``, CXBlock
``gamma``, ``positional_encoding_gaussian_matrix``, ...) keep their names;
the ``_ConvParams`` holders (``encoder_0``, ``dwconv``) are Conv kernels;
flax ``nn.ConvTranspose`` kernels (2, 2, in, out) land in
``ConvTranspose2x``'s (out, in, 2, 2) weight, whose forward reads them as
flax does (tests/test_torch_tracker_modules.py holds it).

The SAM3 teacher's tree needs no rule of its own: ``blocks_<i>`` and
``resblocks_<i>`` are ModuleList entries, the text blocks' ``ln_1`` /
``ln_2`` walk to the ModuleDict entries ``ln.1`` / ``ln.2``, and the raw
parameters (``pos_embed``, ``positional_embedding``, ``text_projection``)
keep their names and layouts. ``converted_shapes`` runs the same walk over
shapes only (``jax.eval_shape`` of a full-size ``init``).

The SAM1 students' trees (``student_sam``) walk by the same rules too:
RepViT's and TinyViT's ``patch_embed_<i>`` / ``blocks_<i>`` /
``stage<s>_block_<i>`` / ``downsample_<i>`` are ModuleList entries, their
ConvBN pairs carry ``params`` and ``batch_stats``, TinyViT's
``attention_biases`` tables keep their (heads, offsets) layout, and the
SAM1 neck (``neck_conv1`` ... ``neck_ln2``) and heads keep their names;
the SAM1 decoder has no object-score head or high-res convs, and its
prompt encoder no mask downscaler, in either tree.

The MobileCLIP towers (``transformer_<i>`` blocks, the raw
``positional_embedding`` and ``projection_layer``), ``AssocHead`` (its
(1, 1, d) ``new_object_embed`` and ``false_positive_embed`` kept as they
are) and the training slice's models walk by the same rules too.

``load_jax_variables`` loads the result with ``strict=True`` after
checking that no key is left over or missing on either side and that
every shape agrees, and fails loudly otherwise. Loading a released
reference torch checkpoint is a later item (ROADMAP).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"(.+)_(\d+)")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(names):
    out = []
    for n in names:
        m = _INDEXED.fullmatch(n)
        out.extend([m.group(1), m.group(2)] if m else [n])
    return out


def _leaf_rule(collection: str, leaf: str, ndim: int):
    """(port leaf name, axis permutation or None) of a flax leaf."""
    if collection == "params":
        if leaf == "kernel":
            if ndim == 2:
                return "weight", (1, 0)
            if ndim == 4:
                return "weight", (3, 2, 0, 1)
            raise ValueError(f"kernel of rank {ndim}")
        if leaf in ("scale", "embedding"):
            return "weight", None
        return leaf, None
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"batch_stats leaf {leaf!r}")
        return names[leaf], None
    raise KeyError(f"variable collection {collection!r} has no port counterpart")


def _walk(variables: Mapping):
    """(state_dict key, flax leaf, axis permutation or None) of every leaf."""
    seen = set()
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            name, axes = _leaf_rule(collection, path[-1], len(value.shape))
            key = ".".join(_module_path(path[:-1]) + [name])
            if key in seen:
                raise KeyError(f"two variables map to {key}")
            seen.add(key)
            yield key, value, axes


def convert_variables(variables: Mapping) -> dict:
    """flax variables -> {state_dict key: float32 numpy array}."""
    out = {}
    for key, value, axes in _walk(variables):
        arr = np.asarray(value, np.float32)
        out[key] = np.ascontiguousarray(arr if axes is None else arr.transpose(axes))
    return out


def converted_shapes(variables: Mapping) -> dict:
    """{state_dict key: shape} of flax variables or of their shapes (any
    leaf with ``.shape``, e.g. ``jax.eval_shape`` of an ``init``): the walk
    of ``convert_variables`` without touching data, for full-size models."""
    return {key: tuple(value.shape) if axes is None
            else tuple(value.shape[a] for a in axes)
            for key, value, axes in _walk(variables)}


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load converted JAX variables into ``model``; every key must match."""
    converted = convert_variables(variables)
    own = model.state_dict()
    missing = sorted(own.keys() - converted.keys())
    unexpected = sorted(converted.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(
            f"state_dict mismatch: {len(missing)} missing {missing[:10]}, "
            f"{len(unexpected)} unexpected {unexpected[:10]}"
        )
    bad = [(k, tuple(own[k].shape), v.shape) for k, v in converted.items()
           if tuple(own[k].shape) != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (key, port, converted): {bad[:10]}")
    model.load_state_dict({k: torch.tensor(v) for k, v in converted.items()}, strict=True)
    return model
