"""The video-PCS detector reads frames as the tracker does, on the CPU.

``EfficientSam3System.video_predictor`` hands the detector and the tracker
the same frames, at the model's resolution and already normalised. The
detector encodes a frame as it is (``Sam3Processor.set_preprocessed_image``),
so its image features are ``encode_frame``'s bit for bit. The JAX
package's detector calls ``set_image``, which normalises the frame a second
time; the port departs from it there, toward the reference, whose video
predictor hands both halves one preprocessed frame. So the detector's
scores, boxes and masks are held against the JAX image model run on the
same frame through its ``_encode_image`` and ``_forward_grounding`` (JAX's
``set_image`` bypassed), at the tiny config of tests/test_torch_slice.py
with the SAM2 neck, within the tolerances of tests/test_torch_pcs_slice.py.
"""

import gzip

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.processor import Sam3Processor as JProcessor
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, init_parameters
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.system import EfficientSam3System
from efficientsam3_tpu_torch.utils.convert import load_jax_variables
from efficientsam3_tpu_torch.video import tracker as ptr
from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig

from test_torch_pcs_slice import SLOTS, TOL
from test_torch_slice import CTX, TOKENS, random_variables
from test_torch_tracker_modules import CFG

SIZE = 64
# the detector keeps the queries whose score (class x presence) passes
# this: the seeded weights score the frame's 200 queries 0.15-0.19, and
# 0.183 keeps 16 of them, each score over 1e-4 (TOL) from it
THRESHOLD = 0.183


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX processor, the port's system) over one set of weights: the tiny
    image model with the SAM2 neck, and a tiny tracker core the detector
    does not use."""
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2, add_sam2_neck=True)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, SIZE, SIZE, 3)), jnp.asarray(TOKENS),
                            JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=5)
    bpe = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version\na b\n")
    jproc = JProcessor(jm, variables, resolution=SIZE, confidence_threshold=THRESHOLD,
                       bpe_path=str(bpe), context_length=CTX)
    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2,
        enable_inst_interactivity=True)
    load_jax_variables(pm, variables)
    core = init_parameters(ptr.TrackerCore(**CFG), seed=0).requires_grad_(False).eval()
    return jproc, EfficientSam3System(pm, core, context_length=CTX)


@pytest.fixture(scope="module")
def frame(models):
    """A 0-255 frame through the processor's preprocess, as the video
    entry points hand frames to the pipeline: (64, 64, 3) normalised."""
    image = np.random.default_rng(8).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    return models[1].processor(resolution=SIZE).preprocess(image)[0].numpy()


def _detect(system, frame, monkeypatch):
    """The video predictor's detector on one frame: its result, and the
    processor state it grounded (image_feats, masks_logits)."""
    seen = {}
    ground = Sam3Processor.run_grounding

    def run_grounding(self, state):
        self.set_confidence_threshold(THRESHOLD)
        seen["state"] = ground(self, state)
        return seen["state"]

    monkeypatch.setattr(Sam3Processor, "run_grounding", run_grounding)
    pipe = system.video_predictor(VideoPCSConfig(obj_slots=4), **SLOTS)
    text_state = {"text": system.processor().encode_tokens(TOKENS)}
    return pipe.detector(frame, text_state), seen["state"]


def test_detector_features_are_encode_frames(models, frame, monkeypatch):
    """The detector's image features equal the tracker's encode_frame of the
    same frame bit for bit, every level of every entry."""
    system = models[1]
    _, state = _detect(system, frame, monkeypatch)
    want = system.encode_frame(torch.from_numpy(frame)[None])
    got = state["image_feats"]
    assert got.keys() == want.keys() and "sam2_fpn" in got
    for key in want:
        assert len(got[key]) == len(want[key]), key
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype and torch.equal(g, w), key


def test_detector_matches_jax_on_the_same_frame(models, frame, monkeypatch):
    """Scores, boxes and masks against the JAX image model grounding the
    same normalised frame (its _encode_image and _forward_grounding)."""
    jproc, system = models
    out, state = _detect(system, frame, monkeypatch)
    v = jproc.variables
    jstate = {"original_height": SIZE, "original_width": SIZE,
              "image_feats": jproc._encode_image(v, jnp.asarray(frame)[None]),
              "text": jproc._encode_text(v, jnp.asarray(TOKENS))}
    jproc._ensure_text(jstate)
    jstate = jproc._forward_grounding(jstate)
    want_scores = np.asarray(jstate["scores"])
    assert 0 < len(want_scores) < 200  # the threshold keeps some queries, not all
    assert out["scores"].shape == want_scores.shape
    for key in ("scores", "boxes"):
        got, want = np.asarray(out[key]), np.asarray(jstate[key])
        assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max()), key
    # masks after thresholding, away from the threshold band (the JAX
    # probabilities within 1e-3 of 0.5 may flip under fp32 rounding)
    want_p = np.asarray(jstate["masks_logits"])
    got_p = np.asarray(state["masks_logits"])
    assert np.abs(got_p - want_p).max() <= TOL
    clear = np.abs(want_p - 0.5) > 1e-3
    assert np.array_equal(np.asarray(out["masks"])[clear], np.asarray(jstate["masks"])[clear])
