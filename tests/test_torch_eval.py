"""The port's evaluation copies against the JAX package's, on the same
numpy-seeded inputs: cgF1, COCO mAP (bbox and segm, crowd, area ranges,
maxDets, the recorded pycocotools numbers), HOTA, TETA, J&F, the video
harness, the shapes fixture and its oracle, the gold file harness and its
subset tables; then postprocess_image / postprocess_video (the port
upsamples masks with ``ops.interpolate`` in torch), ``config.load_config``
and ``utils.visualization.overlay_masks``.

Both sides of an evaluator comparison run the same numpy float64 code, so
the metrics must be equal: to 1e-12 of their size where a sum could run
in another order, and NaN where JAX gives NaN.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax.numpy as jnp

from efficientsam3_tpu.ops.interpolate import resize_bilinear as jax_resize_bilinear

EXACT = 1e-12


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def assert_same(got, want, path="out"):
    """Nested dicts / lists / arrays / numbers equal to EXACT (NaN == NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.dtype, want.dtype)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        if np.isnan(want):
            assert np.isnan(got), (path, got)
        else:
            assert abs(got - want) <= EXACT * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------- cases


def _masks(rng, n, hw=(16, 16), p=0.5):
    return rng.random((n, *hw)) > p


def case_cgf1(pkg, tmp_path):
    """Images with detections and ground truth, misses, false positives on
    negative images, and empty pairs."""
    rng = np.random.default_rng(0)
    ev = mod(pkg, "eval.cgf1").CGF1Evaluator()
    for _ in range(6):
        gt = _masks(rng, int(rng.integers(1, 4)))
        dt = np.concatenate([gt[: int(rng.integers(0, len(gt) + 1))],
                             _masks(rng, int(rng.integers(0, 3)))])
        ev.add_masks(dt, gt)
    for n_dt in (0, 1, 0, 2):
        ev.add_masks(_masks(rng, n_dt), np.zeros((0, 16, 16), bool))
    return ev.summarize()


def case_cgf1_empty_gt(pkg, tmp_path):
    """Only negative images: with and without false positives."""
    rng = np.random.default_rng(1)
    out = {}
    for name, fps in (("clean", (0, 0, 0)), ("fp", (0, 2, 1))):
        ev = mod(pkg, "eval.cgf1").CGF1Evaluator()
        for n in fps:
            ev.add_masks(_masks(rng, n), np.zeros((0, 16, 16), bool))
        out[name] = ev.summarize()
    return out


def _random_boxes(rng, n, side=100):
    xy = rng.uniform(0, side * 0.7, (n, 2))
    wh = rng.uniform(4, side * 0.3, (n, 2))
    return np.concatenate([xy, wh], 1)


def case_coco_bbox(pkg, tmp_path):
    """Random images of shifted, dropped and extra boxes over two categories."""
    rng = np.random.default_rng(2)
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("bbox")
    for _ in range(8):
        for cat in (1, 2):
            gt = _random_boxes(rng, int(rng.integers(0, 5)))
            dt = np.concatenate([gt + rng.normal(0, 3, gt.shape), _random_boxes(rng, 2)])
            keep = rng.random(len(dt)) > 0.2
            ev.add_image(cat, rng.random(int(keep.sum())).tolist(), dt[keep], gt)
    return ev.summarize()


def case_coco_segm(pkg, tmp_path):
    rng = np.random.default_rng(3)
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("segm", max_dets=(1, 5, 20))
    for _ in range(6):
        gt = _masks(rng, int(rng.integers(1, 4)), (24, 24), 0.6)
        noisy = gt ^ (rng.random(gt.shape) > 0.9)
        dt = np.concatenate([noisy, _masks(rng, 1, (24, 24), 0.7)])
        ev.add_image(1, rng.random(len(dt)).tolist(), dt, gt)
    return ev.summarize()


def case_coco_crowd(pkg, tmp_path):
    """tests/test_eval.py's crowd case: a detection on a crowd gt is ignored."""
    gts = np.asarray([[0, 0, 10, 10], [50, 50, 20, 20], [0, 0, 100, 100]], np.float64)
    dts = np.asarray([[20, 20, 30, 30], [0, 0, 10, 10], [50, 50, 20, 20]], np.float64)
    out = {}
    for name, g, crowd in (("crowd", gts, np.asarray([False, False, True])),
                           ("no_crowd", gts[:2], None)):
        ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("bbox")
        ev.add_image(1, [0.95, 0.9, 0.8], dts, g, gt_iscrowd=crowd)
        out[name] = ev.summarize()
    return out


def case_coco_area_maxdets(pkg, tmp_path):
    """tests/test_eval.py's area-range, maxDets and out-of-range-FP cases."""
    out = {}
    gts = np.asarray([[0, 0, 10, 10], [50, 50, 20, 20]], np.float64)
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("bbox")
    ev.add_image(1, [0.9, 0.8], gts.copy(), gts)
    out["small"] = ev.summarize()
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("bbox")
    ev.add_image(1, [0.95, 0.9], np.asarray([[200, 200, 200, 200], [0, 0, 10, 10]], np.float64),
                 gts[:1])
    out["big_fp"] = ev.summarize()
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("bbox")
    ev.add_image(1, [0.9, 0.8], gts, gts, gt_areas=[5000.0, 20000.0])
    out["given_areas"] = ev.summarize()
    return out


def case_coco_pycoco_recorded(pkg, tmp_path):
    """The recorded pycocotools fixture of tests/test_eval.py; each side is
    also held to the recorded numbers at that test's 1e-6."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", "pycoco_oracle.json")
    with open(path) as f:
        fx = json.load(f)
    rle_to_mask = mod(pkg, "eval.coco_format").rle_to_mask
    ev = mod(pkg, "eval.coco_map").CocoMAPEvaluator("segm")
    gt_by_img, dt_by_img = {}, {}
    for a in fx["gt"]["annotations"]:
        gt_by_img.setdefault(a["image_id"], []).append(a)
    for d in fx["dt"]:
        dt_by_img.setdefault(d["image_id"], []).append(d)
    for img in fx["gt"]["images"]:
        gts, dts = gt_by_img.get(img["id"], []), dt_by_img.get(img["id"], [])
        ev.add_image(1, [d["score"] for d in dts],
                     np.stack([rle_to_mask(d["segmentation"]) for d in dts]),
                     np.stack([rle_to_mask(g["segmentation"]) for g in gts]),
                     gt_iscrowd=[g["iscrowd"] for g in gts], gt_areas=[g["area"] for g in gts])
    m = ev.summarize()
    for k, v in fx["metrics"].items():
        if k in m:
            np.testing.assert_allclose(m[k], v, atol=1e-6, err_msg=k)
    return m


def case_hota(pkg, tmp_path):
    """Random frames: id switches, misses, false tracks, IoUs around the
    alphas."""
    rng = np.random.default_rng(4)
    ev = mod(pkg, "eval.hota").HOTAEvaluator()
    for t in range(12):
        g = [i for i in (1, 2, 3) if rng.random() > 0.2]
        p = [10 + i + (5 if t > 6 and i == 2 else 0) for i in (1, 2, 3, 4) if rng.random() > 0.3]
        ev.add_frame(g, p, rng.random((len(g), len(p))))
    return ev.summarize()


def case_teta(pkg, tmp_path):
    rng = np.random.default_rng(5)
    ev = mod(pkg, "eval.teta").TETAEvaluator()
    for t in range(12):
        g = [i for i in (1, 2, 3) if rng.random() > 0.2]
        p = [20 + i for i in (1, 2, 3) if rng.random() > 0.25]
        iou = rng.random((len(g), len(p)))
        if t % 3:
            ev.add_frame(g, p, iou)
        else:
            ev.add_frame(g, p, iou, gt_classes=[i % 2 for i in g],
                         pred_classes=[int(rng.integers(0, 2)) for _ in p])
    return ev.summarize()


def _disk(h, w, cx, cy, r):
    yy, xx = np.mgrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def case_jf(pkg, tmp_path):
    jf = mod(pkg, "eval.jf_metric")
    rng = np.random.default_rng(6)
    gt = np.stack([_disk(48, 64, 20 + t, 24, 10) for t in range(5)])
    pred = np.stack([_disk(48, 64, 21 + t, 25, 9 + t % 2) for t in range(5)])
    noisy = gt ^ (rng.random(gt.shape) > 0.95)
    empty = np.zeros_like(gt)
    return {"j": [jf.j_measure(p, g) for p, g in zip(noisy, gt)],
            "f": [jf.f_measure(p, g) for p, g in zip(noisy, gt)],
            "empty": [jf.j_measure(empty[0], empty[0]), jf.f_measure(empty[0], gt[0])],
            "vos": jf.evaluate_vos({1: pred, 2: noisy, 3: empty}, {1: gt, 2: gt, 3: empty})}


def _square(t, size=64, off=0):
    m = np.zeros((size, size), bool)
    m[10 + t + off: 30 + t + off, 10 + t: 30 + t] = True
    return m


def case_video_eval(pkg, tmp_path):
    """tests/test_video_eval.py's scenes: perfect with other ids, shifted with
    an id switch, and accumulation across videos."""
    ve = mod(pkg, "eval.video_eval")
    gt = [{"obj_ids": [1, 2], "masks": np.stack([_square(t), _square(t, off=25)])}
          for t in range(6)]
    perfect = [{"obj_ids": [7, 9], "masks": f["masks"]} for f in gt]
    shifted = [{"obj_ids": [7, 9] if t < 3 else [8, 9],
                "masks": np.stack([_square(t, off=6), _square(t, off=31)]).astype(np.float32) - 0.5}
               for t in range(6)]
    gone = [{"obj_ids": [], "masks": np.zeros((0, 64, 64), bool)} for _ in range(6)]
    hota, teta = mod(pkg, "eval.hota").HOTAEvaluator(), mod(pkg, "eval.teta").TETAEvaluator()
    deferred = [ve.evaluate_video_predictions(p, gt, hota, teta) for p in (perfect, shifted)]
    return {"perfect": ve.evaluate_video_predictions(perfect, gt),
            "shifted": ve.evaluate_video_predictions(shifted, gt),
            "gone": ve.evaluate_video_predictions(gone, gt),
            "deferred": deferred, "hota": hota.summarize(), "teta": teta.summarize()}


def case_fixtures(pkg, tmp_path):
    """The shapes fixture and the oracle's records, clean and corrupted."""
    fx = mod(pkg, "eval.fixtures")
    images, gt, pairs = fx.make_shapes_fixture(num_images=4, size=64, seed=3)
    out = {"images": images, "gt": gt, "pairs": [list(p) for p in pairs]}
    for name, kw in (("clean", {}), ("jitter", dict(jitter=2.0, drop_prob=0.3, seed=4))):
        predict = fx.oracle_predict_fn(images, gt, **kw)
        out[name] = [predict(images[i], q, pid) for pid, i, q in pairs]
    return out


def _gold_files(tmp_path):
    """The fixture as two annotators' gold files and one silver file."""
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture

    images, gt, _ = make_shapes_fixture(num_images=4, size=64, seed=5)
    second = dict(gt, annotations=gt["annotations"][1:],
                  images=[dict(im, is_instance_exhaustive=im["id"] != 3) for im in gt["images"]])
    for name, g in (("gold_a.json", gt), ("gold_b.json", second),
                    ("sam3_silver_image_droid.json", gt)):
        (tmp_path / name).write_text(json.dumps(g))
    return images, gt


def case_cgf1_files(pkg, tmp_path):
    """evaluate_cgf1_files through run_gold_inference, oracle and noisy
    records, segm and bbox, one and two annotators."""
    images, gt = _gold_files(tmp_path)
    fx, gold = mod(pkg, "eval.fixtures"), mod(pkg, "eval.gold")
    out = {}
    for name, kw in (("oracle", {}), ("noisy", dict(drop_prob=0.5, jitter=3.0, seed=7))):
        records = gold.run_gold_inference(fx.oracle_predict_fn(images, gt, **kw), gt,
                                          lambda info: images[info["image_index"]])
        out[name] = records
        for iou_type in ("segm", "bbox"):
            out[f"{name}_{iou_type}"] = gold.evaluate_cgf1_files(records, [gt], iou_type)
        out[f"{name}_two"] = gold.evaluate_cgf1_files(
            records, [str(tmp_path / "gold_a.json"), str(tmp_path / "gold_b.json")])
    out["shard"] = gold.run_gold_inference(fx.oracle_predict_fn(images, gt), gt,
                                           lambda info: images[info["image_index"]],
                                           max_pairs=6, process_index=1, process_count=2)
    return out


def case_gold_subsets(pkg, tmp_path):
    """The subset tables over files in a folder (a missing subset skipped)."""
    images, gt = _gold_files(tmp_path)
    fx, gold = mod(pkg, "eval.fixtures"), mod(pkg, "eval.gold")

    def load(info):
        return images[info["image_index"]]

    subsets = {"pair": ["gold_a.json", "gold_b.json"], "absent": ["nowhere.json"]}
    return {
        "gold": gold.evaluate_gold_subsets(
            fx.oracle_predict_fn(images, gt, drop_prob=0.3, seed=2), str(tmp_path), load,
            subsets=subsets),
        "silver": gold.evaluate_silver_subsets(
            fx.oracle_predict_fn(images, gt, jitter=2.0, seed=3), str(tmp_path), load,
            subsets=("droid", "bdd100k"), iou_type="bbox"),
    }


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_copy_matches_jax(case, tmp_path):
    want = CASES[case]("efficientsam3_tpu", tmp_path)
    got = CASES[case]("efficientsam3_tpu_torch", tmp_path)
    assert_same(got, want)


def test_oracle_scores_one_through_the_port():
    """The oracle through the port's gold harness scores ~1 (a format fault
    cannot hide behind equal wrong numbers)."""
    from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture, oracle_predict_fn
    from efficientsam3_tpu_torch.eval.gold import evaluate_cgf1_files, run_gold_inference

    images, gt, _ = make_shapes_fixture(num_images=6, size=96, seed=3)
    records = run_gold_inference(oracle_predict_fn(images, gt), gt,
                                 lambda info: images[info["image_index"]])
    out = evaluate_cgf1_files(records, [gt])
    assert out["cgF1"] > 0.95 and out["IL_MCC"] > 0.95, out


# ---------------------------------------------------------------- postprocess

# RLE pixels may differ only where JAX's upsampled logit is this close to 0
# (its matmul resize and F.interpolate sum the same taps in other orders),
# and on at most this share of the compared pixels
BAND = 1e-4
MAX_BAND_SHARE = 1e-3


def _ground_outputs(seed, nq=12, hw=(16, 16), batched=True):
    rng = np.random.default_rng(seed)
    out = {"pred_logits": rng.normal(0, 2, (1, nq, 1)).astype(np.float32),
           "pred_boxes": rng.uniform(0.1, 0.6, (1, nq, 4)).astype(np.float32),
           "pred_masks": rng.normal(0, 3, (1, nq, *hw)).astype(np.float32),
           "presence_logit_dec": rng.normal(0, 1, (1,)).astype(np.float32)}
    if not batched:
        out = {k: v[0] if k != "presence_logit_dec" else v for k, v in out.items()}
    return out


def _jax_upsampled(masks, orig_hw):
    return np.asarray(jax_resize_bilinear(jnp.asarray(masks, jnp.float32)[:, None], orig_hw))[:, 0]


@pytest.mark.parametrize("orig_hw,batched,kw", [
    ((40, 28), True, {}),  # up
    ((9, 6), True, dict(top_k=5)),  # down
    ((16, 16), False, dict(score_threshold=0.2)),  # same size: no resize
    (None, True, dict(encode_rle=False)),  # normalized boxes, masks as they are
    ((40, 28), True, dict(score_threshold=2.0)),  # nothing kept
], ids=["up", "down", "same", "no_hw", "empty"])
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_postprocess_image_matches_jax(orig_hw, batched, kw, as_torch):
    from efficientsam3_tpu.eval.postprocess import postprocess_image as jax_post
    from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask
    from efficientsam3_tpu_torch.eval.postprocess import postprocess_image

    outputs = _ground_outputs(11, batched=batched)
    want = jax_post(outputs, 7, category_id=3, orig_hw=orig_hw, **kw)
    given = {k: torch.from_numpy(v) for k, v in outputs.items()} if as_torch else outputs
    got = postprocess_image(given, 7, category_id=3, orig_hw=orig_hw, **kw)
    assert len(got) == len(want) and (len(want) == 0) == (kw.get("score_threshold", 0) > 1)
    masks = outputs["pred_masks"].reshape(-1, 16, 16)
    order = np.argsort(-_scores(outputs))  # record i is query order[i], as in JAX
    differ = compared = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() and g["image_id"] == 7 and g["category_id"] == 3
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-6)
        if not kw.get("encode_rle", True):
            assert g["segmentation"] == w["segmentation"]
            continue
        gm, wm = rle_to_mask(g["segmentation"]), rle_to_mask(w["segmentation"])
        assert gm.shape == wm.shape
        diff = gm != wm
        if diff.any():
            logit = _jax_upsampled(masks[order[i]][None], orig_hw)[0]
            assert (np.abs(logit[diff]) < BAND).all(), np.abs(logit[diff]).max()
        differ += int(diff.sum())
        compared += diff.size
    assert differ <= MAX_BAND_SHARE * max(compared, 1), (differ, compared)


def _scores(outputs):
    sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))  # noqa: E731
    return sig(outputs["pred_logits"].reshape(-1)) * float(
        sig(outputs["presence_logit_dec"].reshape(-1)[0]))


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_postprocess_video_matches_jax(as_torch):
    from efficientsam3_tpu.eval.postprocess import postprocess_video as jax_post
    from efficientsam3_tpu_torch.eval.postprocess import postprocess_video

    rng = np.random.default_rng(12)
    frames = []
    for t in range(5):
        ids = [3, 5] if t < 3 else [5, 8]
        masks = rng.normal(0, 1, (2, 20, 24)).astype(np.float32)
        frame = {"obj_ids": ids, "masks": masks if t % 2 else masks > 0}
        if t != 4:
            frame["scores"] = rng.random(2).astype(np.float32)
        frames.append(frame)
    want = jax_post(frames, "v0", category_id=2)
    if as_torch:
        frames = [dict(f, masks=torch.from_numpy(np.asarray(f["masks"]))) for f in frames]
    got = postprocess_video(frames, "v0", category_id=2)
    assert_same(got, want)
    assert sorted(r["track_id"] for r in got) == [3, 5, 8]


# ---------------------------------------------------------------- config, visualization


def test_load_config_matches_jax(tmp_path):
    from efficientsam3_tpu import config as jcfg
    from efficientsam3_tpu_torch import config as pcfg

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"epochs": 3, "seed": 9,
                                "model": {"resolution": 504, "backbone_type": "repvit"}}))
    overrides = ["batch_size=8", "model.model_name=m1.1", "model.enable_inst_interactivity=yes",
                 "model.text_encoder_type=MobileCLIP-B", 'save_param_prefixes=["trunk"]',
                 "log_every=5"]
    for args in ((None, None), (str(path), None), (None, overrides), (str(path), overrides)):
        want = jcfg.config_to_dict(jcfg.load_config(jcfg.TrainConfig, *args))
        got = pcfg.config_to_dict(pcfg.load_config(pcfg.TrainConfig, *args))
        assert got == want
    got = pcfg.load_config(pcfg.ModelConfig, overrides=["embed_size=16", "dtype=float32"])
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jcfg.load_config(jcfg.ModelConfig, overrides=["embed_size=16", "dtype=float32"]))


def test_overlay_masks_bit_equal():
    from efficientsam3_tpu.utils.visualization import overlay_masks as jax_overlay
    from efficientsam3_tpu_torch.utils.visualization import overlay_masks

    rng = np.random.default_rng(13)
    image = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    masks = rng.random((23, 24, 32)) > 0.6  # more masks than the palette's 20 colours
    for alpha in (0.5, 0.3):
        got, want = overlay_masks(image, masks, alpha), jax_overlay(image, masks, alpha)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
