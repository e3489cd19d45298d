"""Copy of efficientsam3_tpu/config.py.

Single-tier config system.

Replaces the reference's three config stacks (Hydra/OmegaConf for the
trainer, yacs for stage-1, argparse for eval scripts — SURVEY §5.6) with
plain frozen dataclasses + a tiny override grammar:

    cfg = load_config(ModelConfig, "configs/ev_m.json",
                      overrides=["backbone_type=repvit", "model_name=m1.1"])

Dataclasses compose (train configs embed model configs); JSON files and
`key=value` CLI overrides address nested fields with dots.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone_type: str = "efficientvit"
    model_name: str = "b1"
    text_encoder_type: Optional[str] = "MobileCLIP-S0"
    text_context_length: int = 32
    enable_inst_interactivity: bool = False
    resolution: int = 1008
    embed_size: int = 72
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    batch_size: int = 4
    epochs: int = 30
    seed: int = 0
    log_every: int = 50
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1000
    # partial checkpoints: only params matching these top-level prefixes are
    # saved (reference CheckpointConf.skip_saving_parameters inverted —
    # stage-3 saves only the student trunks, README_stage3.md:259-283)
    save_param_prefixes: Optional[Sequence[str]] = None


def _coerce(val: str, target: Any):
    if isinstance(target, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(target, int):
        return int(val)
    if isinstance(target, float):
        return float(val)
    if target is None:
        try:
            return json.loads(val)
        except json.JSONDecodeError:
            return val
    return type(target)(val)


def _apply(cfg, path: list[str], value: str):
    field = path[0]
    cur = getattr(cfg, field)
    if len(path) == 1:
        return dataclasses.replace(cfg, **{field: _coerce(value, cur)})
    return dataclasses.replace(cfg, **{field: _apply(cur, path[1:], value)})


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default.__class__) and isinstance(v, dict):
            kwargs[f.name] = _from_dict(f.default.__class__, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_config(cls, path: Optional[str] = None, overrides: Optional[Sequence[str]] = None):
    cfg = cls()
    if path:
        with open(path) as f:
            cfg = _from_dict(cls, json.load(f))
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        cfg = _apply(cfg, key.split("."), val)
    return cfg


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
