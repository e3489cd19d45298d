"""The evaluation slice end to end, the port against the JAX package: the
tiny model (the pair of tests/test_torch_slice.py, built once here) grounds
each (image, query) pair of a 2-image shapes fixture through
``run_gold_inference``; its raw outputs go through each package's
``postprocess_image`` into COCO records, and the records through
``evaluate_cgf1_files`` and ``CocoMAPEvaluator``. The port's counterpart of
tests/test_model_to_evaluator.py::test_model_through_evaluators, with a
stub merge table for the tokenizer in place of the CLIP vocab."""

import gzip

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.eval import coco_format as jcf
from efficientsam3_tpu.eval import coco_map as jmap
from efficientsam3_tpu.eval import gold as jgold
from efficientsam3_tpu.eval import postprocess as jpost
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.ops.interpolate import resize_bilinear as jresize
from efficientsam3_tpu.processor import Sam3Processor as JProcessor
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.eval import coco_format as pcf
from efficientsam3_tpu_torch.eval import coco_map as pmap
from efficientsam3_tpu_torch.eval import gold as pgold
from efficientsam3_tpu_torch.eval import postprocess as ppost
from efficientsam3_tpu_torch.eval.fixtures import make_shapes_fixture
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.utils.convert import load_jax_variables

from test_torch_slice import CTX, TOL, random_variables

KEYS = ("pred_logits", "pred_boxes", "pred_masks", "presence_logit_dec")
SIZE = 96
# the gold path keeps every query (200 of 200), so each record pairs with
# one query on both sides
TOP_K = 200
# the metrics are held at this absolute tolerance, float64 rounding: the
# records agree to TOL in score and box and on every mask pixel outside the
# 0.5 band, so a metric could move only where an IoU sits within a pixel of
# a threshold or two scores within TOL swap ranks; on these inputs none
# does, and the two packages' metrics are the same numbers
METRIC_TOL = 1e-9


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' gold runs over the fixture: (records, raw outputs by
    pair) for each, and the fixture."""
    bpe = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version\na b\n")
    tokens = np.zeros((1, CTX), np.int32)
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 64, 64, 3)), jnp.asarray(tokens),
                            JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    jproc = JProcessor(jm, variables, resolution=64, confidence_threshold=0.0,
                       bpe_path=str(bpe), context_length=CTX)
    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2)
    load_jax_variables(pm, variables)
    pproc = Sam3Processor(pm, resolution=64, confidence_threshold=0.0, bpe_path=str(bpe),
                          context_length=CTX)
    images, gt, pairs = make_shapes_fixture(num_images=2, size=SIZE, seed=3)
    raw = {"jax": {}, "port": {}}

    def jax_predict(img, phrase, pair_id):
        state = jproc.set_image(img)
        text = jproc._encode_text(jproc.variables, jnp.asarray(jproc.tokenizer([phrase], CTX)))
        out = jproc._ground(jproc.variables, state["image_feats"]["fpn"],
                            state["image_feats"]["pos"], *text, jproc._empty_prompt())
        out = {k: np.asarray(out[k]) for k in KEYS}
        raw["jax"][pair_id] = out
        return jpost.postprocess_image(out, pair_id, orig_hw=img.shape[:2], top_k=TOP_K)

    @torch.inference_mode()
    def port_predict(img, phrase, pair_id):
        state = pproc.set_image(img)
        tm, tmask = pproc.encode_tokens(pproc.tokenizer([phrase], CTX))
        out = pm.ground(state["image_feats"]["fpn"], state["image_feats"]["pos"], tm, tmask,
                        pproc._empty_prompt())
        raw["port"][pair_id] = {k: out[k].numpy() for k in KEYS}
        return ppost.postprocess_image(out, pair_id, orig_hw=img.shape[:2], top_k=TOP_K)

    def load(info):
        return images[info["image_index"]]

    records = {"jax": jgold.run_gold_inference(jax_predict, gt, load),
               "port": pgold.run_gold_inference(port_predict, gt, load)}
    return records, raw, gt, pairs


def _order(out):
    scores = 1 / (1 + np.exp(-out["pred_logits"][0, :, 0].astype(np.float64)))
    return np.argsort(-scores)


def test_gold_records_match_jax(runs):
    records, raw, gt, pairs = runs
    assert len(records["port"]) == len(records["jax"]) == TOP_K * len(pairs)
    band = clear_px = 0
    for pair_id, _, _ in pairs:
        j_out, p_out = raw["jax"][pair_id], raw["port"][pair_id]
        for k in KEYS:
            err = np.abs(p_out[k] - j_out[k]).max()
            assert err <= TOL * max(1.0, np.abs(j_out[k]).max()), (k, err)
        # record i of a pair is query order[i]; compare by query
        j_recs = [r for r in records["jax"] if r["image_id"] == pair_id]
        p_recs = [r for r in records["port"] if r["image_id"] == pair_id]
        j_by_q = dict(zip(_order(j_out), j_recs))
        p_by_q = dict(zip(_order(p_out), p_recs))
        assert j_by_q.keys() == p_by_q.keys()
        logits = np.asarray(jresize(jnp.asarray(j_out["pred_masks"][0])[:, None],
                                    (SIZE, SIZE)))[:, 0]
        for q, jr in j_by_q.items():
            pr = p_by_q[q]
            assert abs(pr["score"] - jr["score"]) <= TOL
            np.testing.assert_allclose(pr["bbox"], jr["bbox"], rtol=0, atol=TOL * SIZE)
            jm, pm = jcf.rle_to_mask(jr["segmentation"]), pcf.rle_to_mask(pr["segmentation"])
            clear = np.abs(1 / (1 + np.exp(-logits[q])) - 0.5) > 1e-3
            assert np.array_equal(pm[clear], jm[clear]), (pair_id, q)
            band += int((~clear).sum())
            clear_px += int(clear.sum())
    # the band is a sliver of the compared pixels, so the check above covers the masks
    assert band <= 1e-2 * clear_px, (band, clear_px)


def _metrics(records, gt, pairs, gold, cmap, cf):
    out = {"cgf1_" + t: gold.evaluate_cgf1_files(records, [gt], t) for t in ("segm", "bbox")}
    by_pair = {}
    for a in gt["annotations"]:
        by_pair.setdefault(a["image_id"], []).append(a)
    ev = cmap.CocoMAPEvaluator("segm")
    for pair_id, _, _ in pairs:
        recs = [r for r in records if r["image_id"] == pair_id]
        gts = [cf.ann_to_mask(a, SIZE, SIZE) for a in by_pair.get(pair_id, [])]
        ev.add_image(1, [r["score"] for r in recs],
                     np.stack([cf.ann_to_mask(r, SIZE, SIZE) for r in recs]),
                     np.stack(gts) if gts else np.zeros((0, SIZE, SIZE), bool))
    out["map_segm"] = ev.summarize()
    return out


def test_gold_metrics_match_jax(runs):
    records, _, gt, pairs = runs
    want = _metrics(records["jax"], gt, pairs, jgold, jmap, jcf)
    got = _metrics(records["port"], gt, pairs, pgold, pmap, pcf)
    for group, w in want.items():
        for k, v in w.items():
            g = got[group][k]
            assert (np.isnan(g) and np.isnan(v)) or abs(g - v) <= METRIC_TOL, (group, k, g, v)
    for k in ("cgF1", "IL_MCC", "positive_micro_F1"):  # random weights: finite, in range
        assert np.isfinite(got["cgf1_segm"][k]), got
    assert 0.0 <= got["cgf1_segm"]["cgF1"] <= 1.0
