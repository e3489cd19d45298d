"""The tracker slice end to end against the JAX package, at the tiny config:
build_efficientsam3_video_model(model_name="b0", embed_size=8) in both
packages (EfficientViT b0 with the SAM2 neck, 112x112 frames, a TrackerCore
at 8x8 tokens), weights drawn with numpy from a seed over the shapes
``jax.eval_shape`` reports and carried across by ``utils/convert.py``.

TrackerPredictor runs 6 frames: two objects prompted on frame 0 (a box; a
positive and a negative click), frames 1-2 tracked on the cached-bank path,
then a third object added by add_new_mask on frame 3, after which the slots
select different memory frames and frames 4-5 take the plain path. Every
frame's masks, object pointers and object scores are compared, in fp32 on
the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import build_efficientsam3_video_model as jbuild
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.video.predictor import TrackerPredictor as JPredictor
from efficientsam3_tpu.video.tracker import init_tracker_variables
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.utils.convert import load_jax_variables
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

# fp32 through the trunk, neck, memory attention, SAM heads and memory
# encoder over 6 frames of feedback: errors grow to ~1e-5 relative; 1e-4 of
# each output's range leaves margin
TOL = 1e-4
CTX = 16
RES = 112


def random_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, sh)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf in ("embedding", "positional_embedding"):
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _session(pred, frames, mask):
    """Drive one predictor; return per-frame masks and the state."""
    state = pred.init_state(frames)
    pred.add_new_points_or_box(state, 0, obj_id=1, box=[20, 24, 70, 90])
    pred.add_new_points_or_box(state, 0, obj_id=2, points=[[80, 30], [60, 60]], labels=[1, 0])
    masks = {}
    for t, ids, m in pred.propagate_in_video(state):
        masks[t] = np.array(m, np.float32)
        if t == 2:
            break
    pred.add_new_mask(state, 3, obj_id=3, mask=mask)
    for t, ids, m in pred.propagate_in_video(state, start_frame_idx=3):
        assert ids == [1, 2, 3]
        masks[t] = np.array(m, np.float32)
    return masks, state


@pytest.fixture(scope="module")
def runs():
    jimage, jcore = jbuild(model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
                           text_encoder_context_length=CTX)
    tokens = jnp.zeros((1, CTX), jnp.int32)
    ishapes = jax.eval_shape(
        lambda key: jimage.init(key, jnp.zeros((1, RES, RES, 3)), tokens, JPrompt.empty(1, 2, 2)),
        jax.random.PRNGKey(0))
    tshapes = jax.eval_shape(lambda key: init_tracker_variables(jcore, key), jax.random.PRNGKey(0))
    iv, tv = random_variables(ishapes, 0), random_variables(tshapes, 1)
    encode = jax.jit(lambda img: jimage.apply(iv, img, method=jimage.encode_image))

    image, core = build_efficientsam3_video_model(model_name="b0", embed_size=8,
                                                  text_encoder_context_length=CTX, device="cpu")
    load_jax_variables(image, iv)
    load_jax_variables(core, tv)

    rng = np.random.default_rng(0)
    frames = rng.standard_normal((6, RES, RES, 3)).astype(np.float32)
    mask = rng.random((50, 64)) > 0.5
    kw = dict(obj_slots=4, max_point_prompts=4)
    jmasks, jstate = _session(JPredictor(jcore, tv, encode, **kw), frames, mask)

    calls = {"cached": 0, "plain": 0}
    for name, key in (("condition_features_cached", "cached"), ("condition_features", "plain")):
        orig = getattr(core, name)

        def counting(*a, orig_=orig, key_=key, **k):
            calls[key_] += 1
            return orig_(*a, **k)

        setattr(core, name, counting)
    pmasks, pstate = _session(TrackerPredictor(core, image.encode_image, **kw), frames, mask)
    return jmasks, jstate, pmasks, pstate, calls


def test_both_bank_paths_ran(runs):
    _, _, pmasks, pstate, calls = runs
    assert calls == {"cached": 2, "plain": 2}
    # tracked frames carry real masks, not only the no-object fill (-1024)
    for t in (1, 2, 4, 5):
        assert (pmasks[t] != -1024.0).any(axis=(1, 2, 3)).sum() >= 2, t
    assert pstate["kv_bank"][0].shape[2] == 7 * 64 + 64  # padded_bank_len(7 * 8 * 8)


@pytest.mark.parametrize("t", range(6))
def test_frame_outputs_match_jax(runs, t):
    jmasks, jstate, pmasks, pstate, _ = runs
    assert_close(pmasks[t], jmasks[t])
    for frames in ("cond_frames", "non_cond_frames"):
        assert (t in jstate[frames]) == (t in pstate[frames])
        if t in jstate[frames]:
            jo, po = jstate[frames][t], pstate[frames][t]
            np.testing.assert_array_equal(po["slot_valid"], jo["slot_valid"])
            for k in ("obj_ptr", "object_score_logits", "low_res_masks"):
                assert_close(po[k], jo[k])
