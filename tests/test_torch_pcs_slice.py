"""The video-PCS slice end to end against the JAX package, on the CPU.

A small TrackerCore (64x64 frames, 8x8 tokens, d_model 32, mem_dim 8, 3
memories, 4 pointers) gets JAX variables drawn with numpy from a seed and
carried into the port by ``utils/convert.py``; as in
tests/test_video_pipeline.py the object-score head's last bias is raised by
10 so that random weights track objects instead of declaring them gone, the
frame encoder is synthetic (seeded feature maps shifted by the frame's
mean), and the detector is scripted (moving squares at fixed scores). One
predictor of each package serves every scenario, so the JAX programs
compile once.

Held equal between the packages: the order of emitted frames, the object
ids on each, the removed masklets, the detection scores, and the masks
after thresholding at 0 (pixels whose logit lies within 1e-3 of 0 in the
JAX run may flip under fp32 rounding and are not compared). Also: the
TrackerPredictor with the int8 key bank against the exact bank (IoU > 0.98,
the JAX test's bound) and against the JAX predictor, hole filling in
``propagate_in_video``, the session server, the SAM1-task predictor, and
the system handle's guards.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.sam1_task import InteractiveImagePredictor as JInteractive
from efficientsam3_tpu.video import tracker as jtr
from efficientsam3_tpu.video.pipeline import VideoPCSConfig as JConfig
from efficientsam3_tpu.video.pipeline import VideoPCSPredictor as JPipeline
from efficientsam3_tpu.video.predictor import TrackerPredictor as JPredictor
from efficientsam3_tpu.video.server import VideoPredictorServer as JServer
from efficientsam3_tpu_torch.sam1_task import InteractiveImagePredictor
from efficientsam3_tpu_torch.system import EfficientSam3System
from efficientsam3_tpu_torch.utils.convert import load_jax_variables
from efficientsam3_tpu_torch.video import tracker as ptr
from efficientsam3_tpu_torch.video.pipeline import Masklet, VideoPCSConfig, VideoPCSPredictor
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
from efficientsam3_tpu_torch.video.server import VideoPredictorServer
from test_torch_tracker_modules import CFG, random_variables

FS, D = 8, 32
SLOTS = dict(obj_slots=4, max_point_prompts=4)
# fp32 through memory attention, SAM heads and memory encoder with feedback
# over a few frames: ~1e-5 of the range; 1e-4 leaves margin
TOL = 1e-4


def _frames(n, size=64):
    frames = np.zeros((n, size, size, 3), np.float32)
    for t in range(n):
        frames[t, 0, 0, 0] = t / 100.0  # the frame index, read back by the detectors
    return frames


def _frame_index(frame):
    return int(round(float(np.asarray(frame)[0, 0, 0]) * 100))


def moving_square(frame, text_state):
    t = _frame_index(frame)
    m = np.zeros((1, 64, 64), bool)
    m[0, 10 + t:30 + t, 10 + t:30 + t] = True
    return {"masks": m, "scores": np.asarray([0.9]),
            "boxes": np.asarray([[10.0 + t, 10 + t, 30 + t, 30 + t]])}


def square_and_ghost(frame, text_state):
    """A steady square, and a far-away detection on frame 0 only."""
    masks = np.zeros((2, 64, 64), bool)
    masks[0, 10:30, 10:30] = True
    masks[1, 50:60, 50:60] = True
    n = 2 if _frame_index(frame) == 0 else 1
    return {"masks": masks[:n], "scores": np.full(n, 0.9), "boxes": np.zeros((n, 4))}


def duplicate_squares(frame, text_state):
    m = np.zeros((2, 64, 64), bool)
    m[0, 10:30, 10:30] = True
    m[1, 11:31, 11:31] = True  # ~0.8 IoU with the first
    return {"masks": m, "scores": np.asarray([0.9, 0.85]), "boxes": np.zeros((2, 4))}


@pytest.fixture(scope="module")
def pair():
    """(JAX predictor, port predictor, JAX parts, port parts) over one set
    of weights and one synthetic frame encoder."""
    jcore = jtr.TrackerCore(**CFG)
    shapes = jax.eval_shape(lambda key: jtr.init_tracker_variables(jcore, key),
                            jax.random.PRNGKey(0))
    tv = random_variables(shapes, seed=2)
    head = tv["params"]["sam_mask_decoder"]["pred_obj_score_head"]
    last = f"layers_{len(head) - 1}"
    head[last] = dict(head[last], bias=head[last]["bias"] + 10.0)
    pcore = load_jax_variables(ptr.TrackerCore(**CFG), tv).requires_grad_(False).eval()

    rng = np.random.default_rng(3)
    s0 = (0.1 * rng.standard_normal((1, 4 * FS, 4 * FS, D))).astype(np.float32)
    s1 = (0.1 * rng.standard_normal((1, 2 * FS, 2 * FS, D))).astype(np.float32)
    top = (0.1 * rng.standard_normal((1, FS, FS, D))).astype(np.float32)

    def jencode(img):
        return {"sam2_fpn": [jnp.asarray(s0), jnp.asarray(s1),
                             jnp.asarray(top) + jnp.mean(img) * 0.01]}

    def pencode(img):
        return {"sam2_fpn": [torch.from_numpy(s0), torch.from_numpy(s1),
                             torch.from_numpy(top) + img.mean() * 0.01]}

    jpred = JPredictor(jcore, tv, jencode, **SLOTS)
    ppred = TrackerPredictor(pcore, pencode, **SLOTS)
    return jpred, ppred, (jcore, tv, jencode), (pcore, pencode)


def _run_both(pair, cfg, n_frames, detector=moving_square, drive=None, **pipe_kw):
    """Run one scenario through both pipelines; (JAX outputs, port outputs,
    JAX session, port session). drive(pipe, session) -> outputs overrides the
    default forward propagation."""
    jpred, ppred = pair[:2]
    frames = _frames(n_frames)
    res = []
    for pipeline, config, pred in ((JPipeline, JConfig, jpred), (VideoPCSPredictor,
                                                                 VideoPCSConfig, ppred)):
        pipe = pipeline(detector, pred, config(**cfg), **pipe_kw)
        session = pipe.init_session(frames, None)
        outs = drive(pipe, session) if drive else list(pipe.propagate(session))
        res.append((outs, session))
    return res[0][0], res[1][0], res[0][1], res[1][1]


def _assert_same_outputs(jouts, pouts, jsession=None, psession=None):
    assert [o["frame_idx"] for o in pouts] == [o["frame_idx"] for o in jouts]
    for jo, po in zip(jouts, pouts):
        t = jo["frame_idx"]
        assert [int(i) for i in po["obj_ids"]] == [int(i) for i in jo["obj_ids"]], t
        np.testing.assert_array_equal(po["det_scores"], jo["det_scores"])
        jm, pm = np.asarray(jo["masks"]), np.asarray(po["masks"])
        assert pm.shape == jm.shape and pm.dtype == np.float32, (t, pm.shape, jm.shape)
        decided = np.abs(jm) > 1e-3
        assert np.array_equal((pm > 0)[decided], (jm > 0)[decided]), t
        if jm.size:
            assert np.isfinite(pm).all()
    if jsession is not None:
        assert psession["meta"]["removed"] == jsession["meta"]["removed"]
        assert psession["state"]["obj_ids"] == jsession["state"]["obj_ids"]
        assert sorted(psession["masklets"]) == sorted(jsession["masklets"])


def test_pipeline_spawns_tracks_and_fills_holes(pair):
    """No hotstart: the square's masklet is spawned on frame 0 and tracked;
    the config's default fill_hole_area = 16 runs hole filling (scipy here)
    on every emitted mask."""
    cfg = dict(obj_slots=4, hotstart_delay=0, new_det_thresh=0.5)
    jouts, pouts, js, ps = _run_both(pair, cfg, 4)
    _assert_same_outputs(jouts, pouts, js, ps)
    assert len(pouts) == 4 and pouts[0]["obj_ids"] == [0]
    assert all((o["masks"] > 0).any() for o in pouts)
    assert isinstance(ps["masklets"][0], Masklet) and ps["masklets"][0].start_frame == 0
    # filling changed something in the raw tracked masks: +-0.1 patches
    assert any(np.isin(o["masks"], (np.float32(0.1), np.float32(-0.1))).any() for o in pouts)


def test_pipeline_hotstart_retro_emission_with_confirmation(pair):
    cfg = dict(obj_slots=4, hotstart_delay=4, new_det_thresh=0.5, fill_hole_area=0,
               masklet_confirmation_enable=True, masklet_confirmation_consecutive_det_thresh=3,
               assoc_iou_thresh=0.0, trk_assoc_iou_thresh=0.0)
    jouts, pouts, js, ps = _run_both(pair, cfg, 6)
    _assert_same_outputs(jouts, pouts, js, ps)
    assert [o["frame_idx"] for o in pouts] == list(range(6))
    assert len(pouts[0]["obj_ids"]) >= 1 and len(pouts[1]["obj_ids"]) >= 1


def test_pipeline_removes_spurious_masklet(pair):
    """The ghost spawned on frame 0 goes unmatched and is removed inside the
    hotstart window: never emitted, its slot freed, in both packages."""
    cfg = dict(obj_slots=4, hotstart_delay=6, hotstart_unmatch_thresh=3, new_det_thresh=0.5,
               fill_hole_area=0)
    jouts, pouts, js, ps = _run_both(pair, cfg, 8, detector=square_and_ghost)
    _assert_same_outputs(jouts, pouts, js, ps)
    emitted = {i for o in pouts for i in o["obj_ids"]}
    assert ps["meta"]["removed"] == js["meta"]["removed"]
    assert not (emitted & ps["meta"]["removed"])


@pytest.mark.parametrize("nms,n_obj", [(0.7, 1), (0.0, 2)])
def test_pipeline_detector_nms(pair, nms, n_obj):
    cfg = dict(obj_slots=4, hotstart_delay=0, new_det_thresh=0.5, fill_hole_area=0,
               nms_iou_thresh=nms)
    jouts, pouts, js, ps = _run_both(pair, cfg, 2, detector=duplicate_squares)
    _assert_same_outputs(jouts, pouts, js, ps)
    assert len(pouts[0]["obj_ids"]) == n_obj


def test_pipeline_chunked_detection(pair):
    """detector_batch + frame_chunk: 6 frames at chunk 4 make two batched
    calls of fixed width 4 in both packages."""
    calls = []

    def detector_batch(frames, text_state):
        calls.append(np.asarray(frames).shape)
        return [moving_square(f, text_state) for f in np.asarray(frames)]

    cfg = dict(obj_slots=4, hotstart_delay=0, new_det_thresh=0.5, fill_hole_area=0)
    jouts, pouts, js, ps = _run_both(pair, cfg, 6, detector=lambda *a: None,
                                     detector_batch=detector_batch, frame_chunk=4)
    _assert_same_outputs(jouts, pouts, js, ps)
    assert calls == [(4, 64, 64, 3)] * 4  # two calls a package
    assert len(pouts) == 6 and len(pouts[0]["obj_ids"]) >= 1


def test_pipeline_reverse_propagation_and_keep_alive(pair):
    cfg = dict(obj_slots=4, hotstart_delay=2, new_det_thresh=0.5, fill_hole_area=8,
               suppress_unmatched_only_within_hotstart=False,
               decrease_trk_keep_alive_for_empty_masklets=True, o2o_matching_masklets=False)

    def drive(pipe, session):
        return list(pipe.propagate(session, start_frame=3, reverse=True))

    jouts, pouts, js, ps = _run_both(pair, cfg, 4, drive=drive)
    _assert_same_outputs(jouts, pouts, js, ps)
    assert [o["frame_idx"] for o in pouts] == [3, 2, 1, 0]
    assert ps["meta"]["keep_alive"] == js["meta"]["keep_alive"]


def test_pipeline_mid_video_instance_points(pair):
    """A click on a tracked masklet at frame 2 re-conditions its memory: the
    later masks change, and change alike in both packages."""
    cfg = dict(obj_slots=4, hotstart_delay=0, new_det_thresh=0.5, fill_hole_area=0)
    clicked = []

    def drive(pipe, session):
        outs = []
        for o in pipe.propagate(session):
            outs.append(o)
            if o["frame_idx"] == 2:
                clicked.append(np.asarray(pipe.add_instance_points(
                    session, 2, o["obj_ids"][0], points=np.array([[48.0, 48.0]]), labels=[1])))
        return outs

    jouts, pouts, js, ps = _run_both(pair, cfg, 5, drive=drive)
    _assert_same_outputs(jouts, pouts, js, ps)
    jclick, pclick = clicked
    assert pclick.shape == jclick.shape == (32, 32)
    assert np.abs(pclick - jclick).max() <= TOL * max(1.0, np.abs(jclick).max())
    base = _run_both(pair, cfg, 5)[1]
    assert not np.allclose(pouts[-1]["masks"], base[-1]["masks"])
    with pytest.raises(ValueError, match="not tracked"):
        VideoPCSPredictor(moving_square, pair[1]).add_instance_points(ps, 2, 99, [[1, 1]], [1])


def _iou(a, b):
    a, b = a > 0, b > 0
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


@pytest.fixture(scope="module")
def q8_runs(pair):
    """Four frames of one clicked object through the exact and the int8
    bank, in both packages."""
    _, _, (jcore, tv, jencode), (pcore, pencode) = pair
    frames = np.random.default_rng(0).random((4, 64, 64, 3)).astype(np.float32)
    runs = {}
    for qz in (False, True):
        kw = dict(obj_slots=2, max_point_prompts=4, quantize_bank=qz)
        for name, pred in (("jax", JPredictor(jcore, tv, jencode, **kw)),
                           ("port", TrackerPredictor(pcore, pencode, **kw))):
            state = pred.init_state(frames)
            pred.add_new_points_or_box(state, 0, obj_id=7, points=[[20, 20]], labels=[1])
            runs[name, qz] = [np.array(m, np.float32) for _, _, m in
                              pred.propagate_in_video(state)]
    return runs


def test_tracker_quantized_bank_close_to_exact_bank(q8_runs):
    """TrackerPredictor(quantize_bank=True) stays mask-level faithful to the
    exact cached path (IoU > 0.98 a frame), without being identical."""
    for m_exact, m_q8 in zip(q8_runs["port", False], q8_runs["port", True]):
        assert _iou(m_exact, m_q8) > 0.98
    assert any(not np.array_equal(a, b)
               for a, b in zip(q8_runs["port", False], q8_runs["port", True]))


@pytest.mark.parametrize("qz", [False, True])
def test_tracker_quantized_bank_matches_jax(q8_runs, qz):
    for got, want in zip(q8_runs["port", qz], q8_runs["jax", qz]):
        assert got.shape == want.shape == (1, 1, 32, 32)
        assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
        assert (want > 0).any()  # a real mask, not the no-object fill


def test_propagate_fills_holes_like_jax(pair):
    """fill_hole_area > 0 on the TrackerPredictor: holes filled and
    sprinkles removed on the yielded masks, equal to the JAX predictor's up
    to fp32 rounding of the unpatched pixels; +-0.1 patches in the same
    places."""
    _, _, (jcore, tv, jencode), (pcore, pencode) = pair
    frames = np.random.default_rng(1).random((3, 64, 64, 3)).astype(np.float32)
    outs = []
    for pred in (JPredictor(jcore, tv, jencode, fill_hole_area=12, **SLOTS),
                 TrackerPredictor(pcore, pencode, fill_hole_area=12, **SLOTS)):
        state = pred.init_state(frames)
        pred.add_new_points_or_box(state, 0, obj_id=1, box=[10, 12, 40, 44])
        outs.append([(t, ids, np.array(m, np.float32))
                     for t, ids, m in pred.propagate_in_video(state)])
    for (jt, jids, jm), (pt, pids, pm) in zip(*outs):
        assert (jt, jids) == (pt, pids) and pm.shape == jm.shape
        decided = np.abs(jm) > 1e-3
        assert np.array_equal((pm > 0)[decided], (jm > 0)[decided])
        patched = np.isin(jm, (np.float32(0.1), np.float32(-0.1)))
        assert np.array_equal(pm[patched], jm[patched])
    assert isinstance(next(TrackerPredictor(pcore, pencode, fill_hole_area=12, **SLOTS)
                           .propagate_in_video(state))[2], torch.Tensor)


def test_video_predictor_server_sessions_match_jax(pair):
    """start_session / add_points / add_mask / propagate_in_video /
    remove_object / cancel / close_session through both servers."""
    jpred, ppred = pair[:2]
    frames = np.random.default_rng(2).random((4, 64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64), bool)
    mask[30:50, 8:28] = True
    streams = []
    for server in (JServer(jpred), VideoPredictorServer(ppred)):
        sid = server.start_session(frames)
        other = server.start_session(frames[:2])
        server.add_points(sid, 0, 1, points=[[20, 20]], labels=[1])
        server.add_mask(sid, 0, 2, mask)
        stats = server.session_stats()
        assert stats["num_sessions"] == 2 and stats["sessions"][sid]["num_objects"] == 2
        assert stats["sessions"][other]["num_frames"] == 2 and len(stats["devices"]) >= 1
        first = list(server.propagate_in_video(sid))
        server.remove_object(sid, 1)
        second = list(server.propagate_in_video(sid, start_frame_idx=1))
        gen = server.propagate_in_video(sid)
        next(gen)
        server.cancel(sid)
        assert list(gen) == []  # the stream stops at the next frame
        server.close_session(sid)
        with pytest.raises(KeyError):
            server.add_points(sid, 0, 1, points=[[1, 1]], labels=[1])
        server.shutdown()
        assert server.session_stats()["num_sessions"] == 0
        streams.append((first, second))
    for jruns, pruns in zip(*streams):
        assert [r["frame_idx"] for r in pruns] == [r["frame_idx"] for r in jruns]
        for jr, pr in zip(jruns, pruns):
            assert pr["obj_ids"] == jr["obj_ids"] and isinstance(pr["masks"], np.ndarray)
            err = np.abs(pr["masks"] - np.asarray(jr["masks"])).max()
            assert err <= TOL * max(1.0, np.abs(np.asarray(jr["masks"])).max())
    assert VideoPredictorServer(ppred).session_stats()["devices"] == ["cpu"]


@pytest.mark.parametrize("prompt", ["point", "box_and_points", "box_single_mask"])
def test_sam1_task_predict_matches_jax(pair, prompt):
    """InteractiveImagePredictor.predict: masks at the original size, IoU
    predictions and low-res logits, for a click, a box with two clicks, and
    a box without multimask output."""
    _, _, (jcore, tv, jencode), (pcore, pencode) = pair
    image = np.random.default_rng(5).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    kw = {"point": dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1])),
          "box_and_points": dict(box=np.array([10.0, 8.0, 60.0, 40.0]),
                                 point_coords=np.array([[30.0, 20.0], [12.0, 9.0]]),
                                 point_labels=np.array([1, 0])),
          "box_single_mask": dict(box=np.array([10.0, 8.0, 60.0, 40.0]),
                                  multimask_output=False)}[prompt]
    jp, pp = JInteractive(jcore, tv, jencode), InteractiveImagePredictor(pcore, pencode)
    with pytest.raises(ValueError, match="set_image"):
        pp.predict(**kw)
    jp.set_image(image)
    pp.set_image(image)
    jm, ji, jl = jp.predict(**kw)
    pm, pi, pl = pp.predict(**kw)
    n = 1 if prompt == "box_single_mask" else 3
    assert pm.shape == jm.shape == (n, 50, 70) and pm.dtype == bool
    np.testing.assert_allclose(pi, ji, atol=TOL, rtol=TOL)
    assert np.abs(pl - jl).max() <= TOL * max(1.0, np.abs(jl).max())
    hi = np.abs(np.asarray(jax.image.resize(jnp.asarray(jl), (n, 50, 70), "linear"))) > 1e-2
    assert np.array_equal(pm[hi], jm[hi])


def test_sam1_task_predict_batch_matches_jax(pair):
    _, _, (jcore, tv, jencode), (pcore, pencode) = pair
    image = np.random.default_rng(6).random((64, 64, 3)).astype(np.float32)
    pts = np.array([[30.0, 20.0], [50.0, 60.0]], np.float32)
    jp, pp = JInteractive(jcore, tv, jencode), InteractiveImagePredictor(pcore, pencode)
    jp.set_image(image)
    pp.set_image(image)
    want = jp.predict_batch(pts)
    got = pp.predict_batch(pts)
    for name, g, w in zip(("low", "iou", "stability", "boxes", "empty"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name in ("boxes", "empty"):
            np.testing.assert_array_equal(g.numpy(), w)
        elif name == "stability":
            np.testing.assert_allclose(g.numpy(), w, atol=2e-2)  # pixel counts near +-1 may flip
        else:
            assert np.abs(g.numpy() - w).max() <= TOL * max(1.0, np.abs(w).max()), name


def test_system_handle_guards_and_wiring(pair):
    """EfficientSam3System over modules: a system without a tracker core
    refuses the tracker-backed handles; encode_frame needs the SAM2 neck;
    the handles come out wired to the system's modules."""
    pcore, pencode = pair[3]

    class Image(torch.nn.Module):
        text_context_length = 16

        def __init__(self, with_neck):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(1))
            self.with_neck = with_neck

        def encode_image(self, img):
            return pencode(img) if self.with_neck else {"fpn": []}

    bare = EfficientSam3System(Image(True))
    for handle in (bare.tracker_predictor, bare.interactive_predictor, bare.server,
                   bare.video_predictor):
        with pytest.raises(ValueError, match="tracker core"):
            handle()
    with pytest.raises(ValueError, match="SAM2 neck"):
        EfficientSam3System(Image(False), pcore).encode_frame(torch.zeros(1, 64, 64, 3))
    system = EfficientSam3System(Image(True), pcore, context_length=16)
    assert system.processor(resolution=64).context_length == 16
    pred = system.tracker_predictor(quantize_bank=True, fill_hole_area=4, **SLOTS)
    assert pred.core is pcore and pred.quantize_bank and pred.fill_hole_area == 4
    assert isinstance(system.server(**SLOTS), VideoPredictorServer)
    pipe = system.video_predictor(VideoPCSConfig(obj_slots=4), **SLOTS)
    assert isinstance(pipe, VideoPCSPredictor) and pipe.tracker.obj_slots == 4
    state = pred.init_state(np.zeros((2, 64, 64, 3), np.float32))
    pred.add_new_points_or_box(state, 0, obj_id=1, points=[[20, 20]], labels=[1])
    assert len(list(pred.propagate_in_video(state))) == 2
