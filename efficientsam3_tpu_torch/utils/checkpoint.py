"""Training checkpoints: save, auto-resume, partial checkpoints, freeze audit.

Counterpart of the native-checkpoint part of
efficientsam3_tpu/utils/checkpoint.py in the port's own format: a state is
a dict of flat ``{name: tensor}`` maps (``params``, ``batch_stats``) plus
optional entries (the optimizer's ``state_dict``), written with
``torch.save`` to ``<dir>/step_<n>/state.pt`` (to a temporary file first,
then renamed, so a step directory never holds half a checkpoint).
``param_prefixes`` keeps only the parameters under those top-level modules
(partial checkpoints, the reference's skip_saving_parameters). Orbax
checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def save_checkpoint(ckpt_dir: str, step: int, state: dict, param_prefixes=None) -> str:
    """Write ``state`` as step ``step``; with param_prefixes only the
    parameters whose top-level module name starts with one of them."""
    if param_prefixes is not None and "params" in state:
        state = dict(state, params={
            k: v for k, v in state["params"].items()
            if any(_top(k).startswith(p) for p in param_prefixes)})
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest saved step (auto-resume), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))
             and os.path.exists(os.path.join(ckpt_dir, d, "state.pt"))]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, map_location="cpu"):
    """(state, step) of ``step`` (default: the latest), or (None, None)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", "state.pt")
    return torch.load(path, map_location=map_location, weights_only=True), step


def merge_params(base: dict, update: dict) -> dict:
    """Recursively splice ``update`` into ``base`` (checkpoint merges)."""
    out = dict(base)
    for k, v in update.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_params(out[k], v)
        else:
            out[k] = v
    return out


def assert_frozen_unchanged(before: dict, after: dict, frozen_prefixes) -> None:
    """Freeze audit: every tensor under a frozen top-level module is
    bit-identical after training."""
    for name, t in before.items():
        if _top(name) in frozen_prefixes:
            other = after.get(name)
            if other is None or not torch.equal(t, other):
                raise AssertionError(f"frozen param changed: {name}")
