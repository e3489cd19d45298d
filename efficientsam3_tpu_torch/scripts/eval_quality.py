#!/usr/bin/env python
"""Quality numbers (cgF1 / mask AP / box-prompt mIoU) end to end.

Counterpart of scripts/eval_quality.py of the JAX package. One command
runs the whole path (processor -> evaluators) on the synthetic shapes
fixture and writes a JSON file:
  - ``harness_oracle``: metrics of a perfect and a degraded oracle
    predictor, which check the metric plumbing (perfect input scores ~1);
  - ``model``: metrics of the model. With ``--checkpoint`` a released
    EfficientSAM3 checkpoint is loaded (``load_reference_checkpoint``);
    with ``--trained`` the checkpoints train_overfit_quality wrote; with
    neither, the seeded model of train_overfit_quality's config (scores ~0
    by construction).

    python -m efficientsam3_tpu_torch.scripts.eval_quality [--trained runs/overfit] \
        [--checkpoint ckpt.pt] [--out quality.json] [--device cpu]

A text query needs ``EFFICIENTSAM3_BPE_PATH`` (``ClipTokenizer``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts import train_overfit_quality
from efficientsam3_tpu_torch.scripts._common import add_device_flag
from efficientsam3_tpu_torch.utils.checkpoint import load_model_state

ORACLE_FIXTURE = dict(num_images=12, size=112, seed=3)


def _mask_ap(records, gt, pairs, size):
    from efficientsam3_tpu_torch.eval.coco_format import ann_to_mask
    from efficientsam3_tpu_torch.eval.coco_map import CocoMAPEvaluator

    ev = CocoMAPEvaluator("segm")
    by_pair_gt = {}
    for a in gt["annotations"]:
        by_pair_gt.setdefault(a["image_id"], []).append(a)
    by_pair_dt = {}
    for r in records:
        by_pair_dt.setdefault(r["image_id"], []).append(r)
    for pair_id, i, q in pairs:
        recs = by_pair_dt.get(pair_id, [])
        gts = [ann_to_mask(a, size, size) for a in by_pair_gt.get(pair_id, [])]
        dts = [ann_to_mask(r, size, size) for r in recs]
        if not gts and not dts:
            continue
        ev.add_image(
            1, [r["score"] for r in recs],
            np.stack(dts) if dts else np.zeros((0, size, size), bool),
            np.stack(gts) if gts else np.zeros((0, size, size), bool),
        )
    return ev.summarize()


def oracle_metrics():
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
    from efficientsam3_tpu_torch.eval.gold import evaluate_cgf1_files, run_gold_inference

    images, gt, pairs = make_shapes_fixture(**ORACLE_FIXTURE)
    out = {}
    for name, kwargs in (
        ("perfect", {}),
        ("degraded_drop50", {"drop_prob": 0.5, "seed": 7}),
    ):
        predict = oracle_predict_fn(images, gt, **kwargs)
        records = run_gold_inference(
            predict, gt, load_image=lambda info: images[info["image_index"]]
        )
        cg = evaluate_cgf1_files(records, [gt], iou_type="segm")
        m = _mask_ap(records, gt, pairs, ORACLE_FIXTURE["size"])
        out[name] = {
            "cgF1": cg["cgF1"], "IL_MCC": cg["IL_MCC"],
            "positive_micro_F1": cg["positive_micro_F1"],
            "mask_AP": m["AP"], "mask_AP50": m["AP50"],
        }
    return out


def model_config(checkpoint=None, trained=None):
    """(res, embed, ctx, name): a released checkpoint's (EV-M at 1008²),
    the one train_overfit_quality recorded under ``trained``, else its
    MODEL_CFG."""
    if checkpoint:
        return 1008, 72, 32, "m"
    if trained and os.path.exists(os.path.join(trained, "config.json")):
        with open(os.path.join(trained, "config.json")) as f:
            c = json.load(f)
        return c["res"], c["embed"], c["ctx"], c["name"]
    cfg = train_overfit_quality.MODEL_CFG
    return cfg["res"], cfg["embed"], cfg["ctx"], cfg["name"]


def model_metrics(checkpoint=None, trained=None, device="cuda", records_out=None):
    """The model's metrics on train_overfit_quality's FIXTURE; with
    ``records_out`` its COCO-format records are written there too."""
    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset, mask_to_rle, rle_encode_string
    from efficientsam3_tpu_torch.eval.eval_coco import evaluate_box_prompt_miou
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture
    from efficientsam3_tpu_torch.eval.gold import evaluate_cgf1_files, run_gold_inference
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.system import EfficientSam3System
    from efficientsam3_tpu_torch.utils.checkpoint import load_checkpoint, load_reference_checkpoint

    dev = resolve_device(device)
    res, embed, ctx, name = model_config(checkpoint, trained)
    model, core = build_efficientsam3_video_model(
        backbone_type="efficientvit", model_name=name,
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=ctx,
        embed_size=embed, device=dev, seed=0,
    )
    weights = "random_init"
    if checkpoint:
        from efficientsam3_tpu_torch.utils.checkpoint import load_torch_state_dict

        sd = load_torch_state_dict(checkpoint)
        load_reference_checkpoint(model, sd, part="image", backbone_type="efficientvit",
                                  model_name=name, text_encoder_type="MobileCLIP-S0",
                                  add_sam2_neck=True)
        load_reference_checkpoint(core, sd, part="tracker")
        weights = os.path.basename(checkpoint)
    elif trained:
        state, det_step = load_checkpoint(os.path.join(trained, "detector"))
        load_model_state(model, state)
        tstate, _ = load_checkpoint(os.path.join(trained, "tracker"))
        load_model_state(core, tstate)
        weights = f"trained ({trained} @ step {det_step})"

    proc = Sam3Processor(model, resolution=res, context_length=ctx)
    images, gt, pairs = make_shapes_fixture(**train_overfit_quality.FIXTURE)
    fsz = images.shape[1]

    def predict(img, phrase, pair_id):
        state = proc.set_image(img)
        state = proc.set_text_prompt(phrase, state)
        masks = np.asarray(state["masks"])
        scores = np.asarray(state["scores"])
        boxes = np.asarray(state["boxes"])
        recs = []
        for k in range(min(len(scores), 10)):
            m = masks[k, 0] if masks.ndim == 4 else masks[k]
            rle = mask_to_rle(np.asarray(m, bool))
            rle["counts"] = rle_encode_string(rle["counts"])
            x0, y0, x1, y1 = boxes[k]
            recs.append(
                dict(image_id=pair_id, category_id=1, score=float(scores[k]),
                     bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                     segmentation=rle)
            )
        return recs

    records = run_gold_inference(
        predict, gt, load_image=lambda info: images[info["image_index"]]
    )
    if records_out:
        with open(records_out, "w") as f:
            json.dump(records, f)
    cg = evaluate_cgf1_files(records, [gt], iou_type="segm")
    m = _mask_ap(records, gt, pairs, fsz)

    # box-prompt mIoU through the SAM1-task path
    predictor = EfficientSam3System(model, core).interactive_predictor()
    miou = evaluate_box_prompt_miou(
        predictor, CocoDataset(gt),
        load_image=lambda info: images[info["image_index"]],
        max_images=4, max_anns_per_image=2,
    )
    return {
        "weights": weights,
        "config": {"res": res, "embed": embed, "ctx": ctx, "name": name},
        "cgF1": cg["cgF1"], "IL_MCC": cg["IL_MCC"],
        "positive_micro_F1": cg["positive_micro_F1"],
        "mask_AP": m["AP"], "mask_AP50": m["AP50"],
        "box_prompt_miou": miou["miou"],
        "num_pairs": len(pairs),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--trained", default=None,
                    help="dir written by efficientsam3_tpu_torch.scripts.train_overfit_quality")
    ap.add_argument("--out", default="QUALITY_r2.json")
    ap.add_argument("--skip-model", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    result = {"fixture": "synthetic shapes (eval/fixtures.py)",
              "harness_oracle": oracle_metrics()}
    if not args.skip_model:
        records = os.path.splitext(args.out)[0] + "_records.json"
        result["model"] = model_metrics(args.checkpoint, args.trained, args.device,
                                        records_out=records)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
