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


def _convert_leaf(collection: str, leaf: str, arr: np.ndarray):
    if collection == "params":
        if leaf == "kernel":
            if arr.ndim == 2:
                return "weight", arr.T
            if arr.ndim == 4:
                return "weight", arr.transpose(3, 2, 0, 1)
            raise ValueError(f"kernel of rank {arr.ndim}")
        if leaf in ("scale", "embedding"):
            return "weight", arr
        return leaf, arr
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"batch_stats leaf {leaf!r}")
        return names[leaf], arr
    raise KeyError(f"variable collection {collection!r} has no port counterpart")


def convert_variables(variables: Mapping) -> dict:
    """flax variables -> {state_dict key: float32 numpy array}."""
    out = {}
    for collection, tree in variables.items():
        for path, value in _flatten(tree):
            name, arr = _convert_leaf(collection, path[-1], np.asarray(value, np.float32))
            key = ".".join(_module_path(path[:-1]) + [name])
            if key in out:
                raise KeyError(f"two variables map to {key}")
            out[key] = np.ascontiguousarray(arr)
    return out


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
