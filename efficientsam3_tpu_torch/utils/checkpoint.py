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

Reference checkpoints (facebook/sam3 ``sam3.pt``, EfficientSAM3 ``.pt``):
``load_torch_state_dict`` reads one and ``clean_reference_state_dict``
cleans its keys, as in the JAX package; ``load_reference_checkpoint``
carries it through ``utils/convert_model`` (the reference layout to the
flax tree) and ``utils/convert.convert_variables`` (the flax tree to the
port's state_dict) into a port model with ``strict=True``: a key left
over or missing raises.
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


def model_state(model: torch.nn.Module) -> dict:
    """A module's parameters and buffers as a checkpoint state:
    {"params": {name: tensor}, "batch_stats": {name: buffer}}."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "batch_stats": dict(model.named_buffers())}


def load_model_state(model: torch.nn.Module, state: dict, what: str = "checkpoint"):
    """Load a checkpoint state (``model_state``'s, or a partial one) into
    ``model``: an entry the model lacks raises KeyError; what a partial
    state leaves out keeps the model's own value."""
    own = model.state_dict()
    for part in ("params", "batch_stats"):
        unknown = state.get(part, {}).keys() - own.keys()
        if unknown:
            raise KeyError(f"{what}: {part} not in the model: {sorted(unknown)[:5]}")
        own.update(state.get(part, {}))
    model.load_state_dict(own)
    return model


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


# --------------------------------------------------------------------------
# reference (torch) checkpoints
# --------------------------------------------------------------------------


def clean_reference_state_dict(sd: dict) -> dict:
    """Key cleanup per reference model_builder.py:596-622."""
    out = {}
    for k, v in sd.items():
        nk = k
        if nk.startswith("detector."):
            nk = nk[len("detector."):]
        nk = nk.replace("student_trunk.", "")
        out[nk] = v
    return out


def load_torch_state_dict(path: str) -> dict:
    """A reference checkpoint's cleaned state_dict, numpy leaves."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return clean_reference_state_dict(
        {k: v.numpy() if hasattr(v, "numpy") else v for k, v in ckpt.items()})


def load_reference_checkpoint(model: torch.nn.Module, checkpoint, part: str = "image",
                              **convert_kw) -> torch.nn.Module:
    """Load a reference checkpoint (a path, or a state_dict in the
    reference's key space) into a port model, strictly. ``part``: 'image'
    (a ``Sam3ImageModel``; ``convert_kw`` are ``convert_image_model``'s
    backbone_type, model_name, text_encoder_type, add_sam2_neck),
    'tracker' (a ``TrackerCore``; ``convert_tracker_core``'s prefix ``p``)
    or 'vitdet' (the teacher's ``ViTTrunk`` alone; ``convert_vitdet``'s
    prefix ``p``, by default the SAM3 checkpoint's
    ``backbone.vision_backbone.trunk``, and ``depth``)."""
    from efficientsam3_tpu_torch.utils import convert_model
    from efficientsam3_tpu_torch.utils.convert import load_jax_variables

    if isinstance(checkpoint, (str, os.PathLike)):
        sd = load_torch_state_dict(checkpoint)
    else:
        sd = clean_reference_state_dict(checkpoint)
    if part == "image":
        params, stats = convert_model.convert_image_model(sd, **convert_kw)
    elif part == "tracker":
        params, stats = convert_model.convert_tracker_core(sd, **convert_kw)
    elif part == "vitdet":
        convert_kw.setdefault("p", "backbone.vision_backbone.trunk")
        params, stats = convert_model.convert_vitdet(sd, **convert_kw)
    else:
        raise ValueError(f"part must be 'image', 'tracker' or 'vitdet', not {part!r}")
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return load_jax_variables(model, variables)
