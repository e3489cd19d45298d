"""The port's evaluation and data entry points on the CPU, each
``main(argv)`` called in-process (the tiny config, b0 at 112², where a
model runs: the builders replaced in the script's namespace):

  - data_engine (stub backend) and standalone_cgf1: the files and metrics
    equal what the JAX scripts write and print on the same input (host
    code: exact);
  - eval_video on a 6-frame fixture, its detector's outputs replaced by
    the frame's red squares found by colour (the seeded detector finds
    nothing), so the tracker has objects: per-video J&F, HOTA and TETA
    against the same pipeline composed from the library, and against the
    JAX evaluators on the same predictions, within 1e-3;
  - eval_coco: the box-prompt mIoU against the library's on the same
    system.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_threads  # noqa: F401

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.scripts import _common
from efficientsam3_tpu_torch.scripts import data_engine, eval_coco, eval_video, standalone_cgf1

ROOT = Path(__file__).resolve().parents[1]


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_video_model(*, dtype=None, device=None, **kw):
    kw = dict(kw, model_name="b0", embed_size=8, text_encoder_context_length=16)
    return build_efficientsam3_video_model(**kw, device="cpu")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return _common.write_shapes_coco(str(tmp_path_factory.mktemp("coco")), num_images=3,
                                     size=112)


def test_data_engine_writes_what_jax_writes(coco, tmp_path, monkeypatch):
    root = coco.rsplit("/", 1)[0]
    common = ["--ann", coco, "--image-root", root, "--min-confidence", "0.3"]
    got = data_engine.main(common + ["--output-root", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["data_engine.py", *common, "--output-root",
                                      str(tmp_path / "jax")])
    jax_script("data_engine").main()
    assert got["num_records"] > 0 and got["num_images"] == 3
    for name in ("raw_records.jsonl", "pseudo_labels_coco.json", "audit.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_standalone_cgf1_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
    from efficientsam3_tpu_torch.eval.gold import run_gold_inference

    images, gt, _ = make_shapes_fixture(num_images=4, size=112, seed=3)
    records = run_gold_inference(oracle_predict_fn(images, gt, drop_prob=0.3, seed=2), gt,
                                 load_image=lambda info: images[info["image_index"]])
    (tmp_path / "pred.json").write_text(json.dumps(records))
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    args = ["--pred_file", str(tmp_path / "pred.json"), "--gt_files", str(tmp_path / "gt.json")]
    for iou_type in ("segm", "bbox"):
        got = standalone_cgf1.main(args + ["--iou_type", iou_type, "--device", "cpu"])
        port_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["standalone_cgf1.py", *args, "--iou_type", iou_type])
        jax_script("standalone_cgf1").main()
        assert port_out == capsys.readouterr().out
        assert 0.0 < got["cgF1"] < 1.0


def flatten(tree, prefix=""):
    """{path: float} of the numbers in nested dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flatten(v, f"{prefix}{i}/").items()}
    return {prefix: float(tree)} if isinstance(tree, (int, float)) else {}


def red_squares(frame):
    """The red squares of a normalised frame as (masks, scores, boxes)."""
    from scipy import ndimage

    rgb = (np.asarray(frame) * 0.5 + 0.5) * 255
    red = (rgb[..., 0] > 180) & (rgb[..., 1] < 80) & (rgb[..., 2] < 80)
    lab, n = ndimage.label(red)
    masks = np.stack([lab == k for k in range(1, n + 1)]) if n else np.zeros((0, *red.shape), bool)
    boxes = np.asarray([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                        for ys, xs in (np.nonzero(m) for m in masks)], np.float32).reshape(-1, 4)
    return {"masks": masks, "scores": np.full(n, 0.9, np.float32), "boxes": boxes}


def test_eval_video_matches_the_library_and_jax_evaluators(tmp_path, monkeypatch):
    from efficientsam3_tpu.eval.hota import HOTAEvaluator as JHOTA
    from efficientsam3_tpu.eval.teta import TETAEvaluator as JTETA
    from efficientsam3_tpu.eval.video_eval import evaluate_video_predictions as jevaluate
    from efficientsam3_tpu_torch.eval.video_eval import evaluate_video_predictions
    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.system import EfficientSam3System
    from efficientsam3_tpu_torch.video.io import load_video_frames
    from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig, VideoPCSPredictor

    monkeypatch.setenv("EFFICIENTSAM3_BPE_PATH",
                       _common.write_byte_level_bpe(str(tmp_path / "bpe.txt.gz")))
    dataset = _common.write_video_fixture(str(tmp_path / "video"), frames=6, size=112,
                                          mask_side=32)
    monkeypatch.setattr(eval_video, "build_efficientsam3_video_model", tiny_video_model)
    real = eval_video.make_detector
    preds_seen = []

    def make_detector(proc, text_state):
        detect = real(proc, text_state)

        def detector(frame, ts):
            out = detect(frame, ts)  # the model's detector runs on every frame
            assert len(out["scores"]) == 0  # seeded weights: nothing above 0.5
            return red_squares(frame)

        return detector

    monkeypatch.setattr(eval_video, "make_detector", make_detector)
    real_eval = eval_video.evaluate_video_predictions

    def keep(preds, gts, hota, teta):
        preds_seen.append((preds, gts))
        return real_eval(preds, gts, hota, teta)

    monkeypatch.setattr(eval_video, "evaluate_video_predictions", keep)
    out = tmp_path / "metrics.json"
    got = eval_video.main(["--dataset", dataset, "--resolution", "112", "--out", str(out),
                           "--device", "cpu"])
    assert json.loads(out.read_text())["per_video_JF"] == got["per_video_JF"]
    jf = got["per_video_JF"]["0"]
    assert jf["J&F"] > 0.5 and 0.0 < got["HOTA"] <= 1.0

    # the library composed by hand
    model, core = tiny_video_model()
    proc = Sam3Processor(model, resolution=112)
    frames = load_video_frames(str(tmp_path / "video" / "frames"), resolution=112)
    frames = (frames.astype(np.float32) / 255.0 - 0.5) / 0.5
    cfg = VideoPCSConfig()
    pipe = VideoPCSPredictor(lambda f, ts: red_squares(f),
                             EfficientSam3System(model, core).tracker_predictor(
                                 obj_slots=cfg.obj_slots), cfg)
    preds = list(pipe.run_video(frames, text_state=None))
    gts = eval_video.load_gt_frames(str(tmp_path / "video"),
                                    json.loads(Path(dataset).read_text())["videos"][0]["annotations"])
    lib = evaluate_video_predictions(preds, gts)
    # the JAX evaluators on the script's own predictions
    jhota, jteta = JHOTA(), JTETA()
    want = jevaluate(*preds_seen[0], jhota, jteta)
    for k in ("J", "F", "J&F"):
        assert abs(jf[k] - lib[k]) <= 1e-3 and abs(jf[k] - want[k]) <= 1e-3, k
    summary = {**jhota.summarize(), **jteta.summarize()}
    assert {"HOTA", "TETA", "per_alpha"} <= summary.keys()
    flat_got, flat_want = flatten(got), flatten(summary)
    assert flat_want.keys() <= flat_got.keys()
    for k, v in flat_want.items():
        assert abs(flat_got[k] - v) <= 1e-3, k
    assert abs(got["HOTA"] - lib["HOTA"]) <= 1e-3


def test_eval_coco_matches_the_library(coco, monkeypatch):
    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset
    from efficientsam3_tpu_torch.eval.eval_coco import evaluate_box_prompt_miou
    from efficientsam3_tpu_torch.system import EfficientSam3System

    monkeypatch.setattr(eval_coco, "build_efficientsam3_video_model", tiny_video_model)
    root = coco.rsplit("/", 1)[0]
    got = eval_coco.main(["--ann", coco, "--images-dir", root, "--max-images", "2",
                          "--device", "cpu"])
    pred = EfficientSam3System(*tiny_video_model()).interactive_predictor()
    want = evaluate_box_prompt_miou(
        pred, CocoDataset(coco), lambda info: _common.load_rgb(f"{root}/{info['file_name']}"),
        max_images=2)
    assert got["num_instances"] > 0 and 0.0 <= got["miou"] <= 1.0
    assert got == want
