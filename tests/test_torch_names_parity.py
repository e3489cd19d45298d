"""The public names the port gained to match the JAX package's modules,
each held against its JAX counterpart on the CPU: the resizes,
``iou_loss``, ``geometry_labels``, ``sine_encode_points``,
``box_xyxy_to_cxcywh``, the trunks' out-channel tables, ViTDet's RoPE
helpers, ``solve_assignment``, ``init_tracker_variables``,
``fuse_repvit_params`` and the observability helpers (``trace_span``,
``profile``, ``device_memory_stats``, ``ShapeLogger``)."""

import json

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax.numpy as jnp

RNG = np.random.default_rng(0)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("size,align", [((11, 5), False), ((4, 13), True), ((7, 9), False)])
def test_resize_matches_jax(mode, size, align):
    from efficientsam3_tpu.ops import interpolate as J
    from efficientsam3_tpu_torch.ops import interpolate as P

    x = RNG.standard_normal((2, 3, 7, 9)).astype(np.float32)
    if mode == "nearest":
        want, got = J.resize(jnp.asarray(x), size, mode), P.resize(torch.from_numpy(x), size, mode)
    else:
        want = J.resize(jnp.asarray(x), size, mode, align)
        got = P.resize(torch.from_numpy(x), size, mode, align)
    assert got.shape == want.shape
    _close(got, want)
    fn = {"bilinear": (J.resize_bilinear, P.resize_bilinear),
          "bicubic": (J.resize_bicubic, P.resize_bicubic)}.get(mode)
    if fn:  # the direct calls, on a 3-d input (any leading shape)
        _close(fn[1](torch.from_numpy(x[0]), size, align), fn[0](jnp.asarray(x[0]), size, align))
    else:
        _close(P.resize_nearest(torch.from_numpy(x[0]), size), J.resize_nearest(jnp.asarray(x[0]), size))


@pytest.mark.parametrize("l1", [False, True])
def test_iou_loss_matches_jax(l1):
    from efficientsam3_tpu.train.losses import iou_loss as jiou
    from efficientsam3_tpu_torch.train.losses import iou_loss

    pm = RNG.standard_normal((3, 2, 8, 8)).astype(np.float32)
    tm = (RNG.random((3, 2, 8, 8)) > 0.5).astype(np.float32)
    pi = RNG.random((3, 2)).astype(np.float32)
    _close(iou_loss(torch.from_numpy(pm), torch.from_numpy(tm), torch.from_numpy(pi), 4.0, l1),
           jiou(jnp.asarray(pm), jnp.asarray(tm), jnp.asarray(pi), 4.0, l1))


def test_geometry_labels_match_jax():
    from flax import traverse_util

    from efficientsam3_tpu.train.geometry_finetune import geometry_labels as jlabels
    from efficientsam3_tpu_torch.train.geometry_finetune import geometry_labels

    tree = {"trunk": {"stem": {"kernel": 0}, "head": {"bias": 0}},
            "decoder": {"layers_0": {"kernel": 0}}, "scoring": {"bias": 0}}
    want = {".".join(k): v for k, v in traverse_util.flatten_dict(jlabels(tree)).items()}
    assert geometry_labels({k: None for k in want}) == want

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = torch.nn.Linear(2, 2)
            self.decoder = torch.nn.Linear(2, 2)

    assert geometry_labels(M()) == {"trunk.weight": "trunk", "trunk.bias": "trunk",
                                    "decoder.weight": "frozen", "decoder.bias": "frozen"}


def test_point_and_box_encodings_match_jax():
    from efficientsam3_tpu.models.common import sine_encode_points as jsine
    from efficientsam3_tpu.models.decoder import box_xyxy_to_cxcywh as jbox
    from efficientsam3_tpu_torch.models.common import sine_encode_points
    from efficientsam3_tpu_torch.models.decoder import box_xyxy_to_cxcywh

    x, y = RNG.random((2, 5)).astype(np.float32), RNG.random((2, 5)).astype(np.float32)
    labels = RNG.integers(-1, 4, (2, 5)).astype(np.int32)
    got = sine_encode_points(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(labels), 64)
    _close(got, jsine(jnp.asarray(x), jnp.asarray(y), jnp.asarray(labels), 64))
    b = RNG.random((3, 4)).astype(np.float32)
    _close(box_xyxy_to_cxcywh(torch.from_numpy(b)), jbox(jnp.asarray(b)))


def test_out_channel_tables_match_jax_and_the_trunks():
    from efficientsam3_tpu.models import efficientvit as jev
    from efficientsam3_tpu.models import repvit as jrv
    from efficientsam3_tpu.models import tiny_vit as jtv
    from efficientsam3_tpu_torch.models import efficientvit, repvit, tiny_vit

    assert efficientvit.EFFICIENTVIT_OUT_CHANNELS == jev.EFFICIENTVIT_OUT_CHANNELS
    assert repvit.REPVIT_OUT_CHANNELS == jrv.REPVIT_OUT_CHANNELS
    assert tiny_vit.TINYVIT_OUT_CHANNELS == jtv.TINYVIT_OUT_CHANNELS
    with torch.device("meta"):
        for name, fn in efficientvit.EFFICIENTVIT_VARIANTS.items():
            assert fn().out_channels == efficientvit.EFFICIENTVIT_OUT_CHANNELS[name]


def test_vitdet_rope_helpers_match_jax():
    from efficientsam3_tpu.models import vitdet as J
    from efficientsam3_tpu_torch.models import vitdet as P

    jc, js = J.axial_rope_cos_sin(16, 5, 3, scale_pos=24 / 5)
    c, s = P.axial_rope_cos_sin(16, 5, 3, scale_pos=24 / 5)
    _close(c, jc)
    _close(s, js)
    x = RNG.standard_normal((2, 15, 16)).astype(np.float32)
    _close(P.apply_rope_pairs(torch.from_numpy(x), c, s),
           J.apply_rope_pairs(jnp.asarray(x), jc, js))


def test_solve_assignment_matches_jax():
    from efficientsam3_tpu.ops.hungarian import solve_assignment as jsolve
    from efficientsam3_tpu_torch.ops.hungarian import solve_assignment

    cost = RNG.random((4, 9)).astype(np.float32)
    np.testing.assert_array_equal(solve_assignment(cost), np.asarray(jsolve(jnp.asarray(cost))))


def test_init_tracker_variables_returns_the_seeded_parameters():
    from efficientsam3_tpu_torch.video.tracker import (
        TrackerCore,
        init_tracker_parameters,
        init_tracker_variables,
    )

    core = TrackerCore(image_size=112)
    variables = init_tracker_variables(core, seed=3)
    again = init_tracker_parameters(TrackerCore(image_size=112), seed=3)
    assert set(variables) == {"params"}
    assert variables["params"].keys() == dict(again.named_parameters()).keys()
    for k, p in again.named_parameters():
        assert torch.equal(variables["params"][k], p), k


def test_fuse_repvit_params_is_the_state_dict_fold():
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models import repvit

    cfgs = repvit._m0_9_cfgs()[:2]
    m = init_parameters(repvit.RepViT(cfgs), 0)
    with torch.no_grad():
        for b in m.buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5)
    params = {k: p.detach() for k, p in m.named_parameters()}
    stats = dict(m.named_buffers())
    got = repvit.fuse_repvit_params(params, stats, cfgs)
    want = repvit.fuse_repvit_state_dict(m.state_dict(), cfgs)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_observability_helpers(tmp_path):
    from efficientsam3_tpu.utils import observability as J
    from efficientsam3_tpu_torch.utils import observability as P

    with P.profile(str(tmp_path)) as prof:
        with P.trace_span("cli-span"):
            torch.ones(4).sum()
    assert "cli-span" in {e.key for e in prof.key_averages()}
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "cli-span" for e in trace["traceEvents"])

    # the host's memory statistics: zeros under the same keys as JAX's CPU devices
    want = list(J.device_memory_stats().values())
    assert list(P.device_memory_stats().values()) == want[:1]

    calls = [((2, 3), (4,)), ((2, 3), (4,)), ((5,), (4,)), ((2, 3), (4,))]
    jl, pl = J.ShapeLogger(lambda a, b: 0, "j"), P.ShapeLogger(lambda a, b: 0, "p")
    for sa, sb in calls:
        jl(jnp.zeros(sa), b=jnp.zeros(sb))
        pl(torch.zeros(sa), b=torch.zeros(sb))
    assert pl.seen == jl.seen and len(pl.seen) == 2
