#!/usr/bin/env python
"""Checkpoint integrity verifier.

Counterpart of scripts/verify_checkpoint.py of the JAX package (reference
sam3/stage3/verify_checkpoint_integrity.py, sanity_check_merge.py): checks
a checkpoint against a model of the requested config built by the port
and reports

  - missing parameters (in the model, absent from the checkpoint)
  - unexpected parameters (in the checkpoint, absent from the model)
  - shape mismatches
  - non-finite tensors (NaN / Inf counts)
  - the parameter count and bytes checked

It reads the port's checkpoints (``--ckpt-dir``: ``utils/checkpoint``'s
``step_<n>/state.pt``, as the Trainer and train_overfit_quality write
them) and torch ``.pt`` files (``--torch-pt``): a state_dict in the port's
names, or a reference checkpoint, carried through the reference converters
(``utils/convert_model``) first. ``main`` returns the exit code: 0 iff
nothing is missing, mismatched or non-finite (unexpected keys are a
warning unless ``--strict``); 1 otherwise.

    python -m efficientsam3_tpu_torch.scripts.verify_checkpoint --ckpt-dir runs/stage3 \
        --backbone efficientvit --model-name b1
    python -m efficientsam3_tpu_torch.scripts.verify_checkpoint --torch-pt merged.pt ...
"""

from __future__ import annotations

import argparse
import sys

import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag


def compare(want: dict, got: dict):
    """Compare flat {name: shape} (want) and {name: tensor or array} (got).

    Returns (missing, unexpected, mismatched, nonfinite, n_params, n_bytes)."""
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    mismatched, nonfinite = [], []
    n_params = n_bytes = 0
    for k in sorted(set(want) & set(got)):
        g = torch.as_tensor(got[k])
        n_params += g.numel()
        n_bytes += g.numel() * g.element_size()
        if tuple(g.shape) != tuple(want[k]):
            mismatched.append((k, tuple(g.shape), tuple(want[k])))
        elif g.is_floating_point():
            bad = int((~torch.isfinite(g)).sum())
            if bad:
                nonfinite.append((k, bad))
    return missing, unexpected, mismatched, nonfinite, n_params, n_bytes


def reference_params(sd: dict, backbone: str, model_name: str, text_encoder: str) -> dict:
    """A reference checkpoint's parameters in the port's names."""
    from efficientsam3_tpu_torch.utils import convert_model
    from efficientsam3_tpu_torch.utils.checkpoint import clean_reference_state_dict
    from efficientsam3_tpu_torch.utils.convert import convert_variables

    sd = clean_reference_state_dict(
        {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()})
    params, _ = convert_model.convert_image_model(
        sd, backbone_type=backbone, model_name=model_name, text_encoder_type=text_encoder)
    return convert_variables({"params": params})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", help="checkpoint directory (utils/checkpoint)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--torch-pt", help="torch state-dict .pt to verify instead")
    ap.add_argument("--backbone", default="efficientvit")
    ap.add_argument("--model-name", default="b1")
    ap.add_argument("--text-encoder", default="MobileCLIP-S0")
    ap.add_argument("--context-length", type=int, default=32)
    ap.add_argument("--strict", action="store_true",
                    help="unexpected checkpoint keys are fatal")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    model = build_efficientsam3_image_model(
        backbone_type=args.backbone, model_name=args.model_name,
        text_encoder_type=args.text_encoder,
        text_encoder_context_length=args.context_length,
        device=resolve_device(args.device),
    )
    want = {k: tuple(p.shape) for k, p in model.named_parameters()}
    del model

    if args.torch_pt:
        sd = torch.load(args.torch_pt, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and isinstance(sd.get(key), dict):
                sd = sd[key]
        if len(set(sd) & set(want)) * 2 >= len(sd):  # already in the port's names
            got = dict(sd)
        else:
            try:
                got = reference_params(sd, args.backbone, args.model_name, args.text_encoder)
            except KeyError as e:  # the converter needs a key the checkpoint lacks
                print(f"reference conversion failed: missing key {e}")
                print("INTEGRITY FAILED")
                return 1
    else:
        from efficientsam3_tpu_torch.utils.checkpoint import load_checkpoint

        state, step = load_checkpoint(args.ckpt_dir, args.step)
        if state is None:
            print(f"no checkpoint under {args.ckpt_dir}")
            print("INTEGRITY FAILED")
            return 1
        print(f"loaded step {step}")
        got = state.get("params", state)

    missing, unexpected, mismatched, nonfinite, n_params, n_bytes = compare(want, got)

    print(f"parameters checked: {n_params:,} ({n_bytes / 1e6:.1f} MB)")
    for name, rows in (("missing", missing), ("unexpected", unexpected)):
        print(f"{name}: {len(rows)}")
        for k in rows[:20]:
            print(f"  {k}")
    print(f"shape mismatches: {len(mismatched)}")
    for k, g, w in mismatched[:20]:
        print(f"  {k}: ckpt {g} vs model {w}")
    print(f"non-finite tensors: {len(nonfinite)}")
    for k, bad in nonfinite[:20]:
        print(f"  {k}: {bad} bad values")

    fatal = bool(missing or mismatched or nonfinite)
    if args.strict:
        fatal = fatal or bool(unexpected)
    print("INTEGRITY OK" if not fatal else "INTEGRITY FAILED")
    return 1 if fatal else 0


if __name__ == "__main__":
    sys.exit(main())
