"""The video-PCS slice's modules in the PyTorch port against the JAX
package, on the CPU: the cached memory attention over the int8 bank, the
mask utilities (IoU matrix, boxes, NMS), connected components and hole
filling (tensor and host versions), the distance transform, the port's copy
of the host C++ library (built by g++ here, skipped where there is none),
click sampling and the frame loaders. The same seeded numpy inputs go
through both; integer outputs are compared exactly.
"""

import shutil

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from efficientsam3_tpu.ops import cc as jcc
from efficientsam3_tpu.ops import edt as jedt
from efficientsam3_tpu.ops import masks as jmasks
from efficientsam3_tpu.video import click_sampling as jclicks
from efficientsam3_tpu.video import tracker as jtr
from efficientsam3_tpu_torch.ops import cc as pcc
from efficientsam3_tpu_torch.ops import edt as pedt
from efficientsam3_tpu_torch.ops import masks as pmasks
from efficientsam3_tpu_torch.video import click_sampling as pclicks
from efficientsam3_tpu_torch.video import io as pio
from efficientsam3_tpu_torch.video import tracker as ptr
from test_torch_tracker_modules import B, NM, _banks, _japply, _t, assert_close
from test_torch_tracker_modules import cores, inputs  # noqa: F401  (fixtures)

EIGHT = np.ones((3, 3), int)


@pytest.fixture
def host_lib():
    """The port's host library; it needs a C++ compiler (g++ or nvcc)."""
    if shutil.which("g++") is None and shutil.which("nvcc") is None:
        pytest.skip("no C++ compiler: the host library cannot be built here")
    from efficientsam3_tpu_torch import native

    native.lib()
    return native


@pytest.mark.parametrize("shared", [False, True])
def test_condition_features_cached_quantized_bank(cores, inputs, shared):  # noqa: F811
    """condition_features_cached(quantize_bank=True) in both packages: per
    layer the age-adjusted keys are row-quantized and attended through the
    dequantize path (the CPU path of both). The int8 rows are equal, so the
    outputs agree to fp32 rounding (2e-5 of the range); slot 2 is empty and
    is not compared."""
    jcore, v, pcore = cores
    i = dict(inputs)
    if shared:
        i["tpos"] = np.broadcast_to(np.array([2, 0, 1]), (B, NM)).copy()
        i["valid"] = np.broadcast_to(np.array([True, True, False]), (B, NM)).copy()
    jk, jv = _banks(lambda m: _japply(jcore, v, jcore.encode_memory_kv, m), jnp.asarray(i["mem"]),
                    jtr.flatten_kv_bank)
    pk, pv = _banks(pcore.encode_memory_kv, _t(i["mem"]), ptr.flatten_kv_bank)
    jdelta, pdelta = _japply(jcore, v, jcore.tpos_k_delta), pcore.tpos_k_delta()
    args = (i["tokens"], i["pos"])
    rest = (i["tpos"], i["valid"], i["ptrs"], i["tdiff"], i["pvalid"])
    want = jcore.apply(v, *args, jk, jv, *rest, jdelta, 4.0, shared_ages=shared,
                       quantize_bank=True, method=jcore.condition_features_cached)
    got = pcore.condition_features_cached(*(_t(a) for a in args), pk, pv, *(_t(a) for a in rest),
                                          pdelta, 4.0, shared_ages=shared, quantize_bank=True)
    assert_close(got[:2], want[:2])
    exact = pcore.condition_features_cached(*(_t(a) for a in args), pk, pv,
                                            *(_t(a) for a in rest), pdelta, 4.0,
                                            shared_ages=shared)
    assert not torch.equal(got[:2], exact[:2])


def _mask_sets(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((5, 24, 32)) > 0.6
    b = rng.random((4, 24, 32)) > 0.4
    a[2] = False  # an empty mask: IoU 0 by the eps floor, zero box
    b[1] = a[0]
    return a, b


def test_mask_iou_and_intersection_match_jax():
    a, b = _mask_sets()
    np.testing.assert_array_equal(
        pmasks.mask_intersection_matrix(_t(a), _t(b)).numpy(),
        np.asarray(jmasks.mask_intersection_matrix(jnp.asarray(a), jnp.asarray(b))))
    got = pmasks.mask_iou(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmasks.mask_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=0)
    assert got[0, 1] == 1.0 and (got[2] == 0).all()


def test_masks_to_boxes_matches_jax():
    a, _ = _mask_sets(1)
    got = pmasks.masks_to_boxes(_t(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasks.masks_to_boxes(jnp.asarray(a))))
    assert (got[2] == 0).all()
    ys, xs = np.nonzero(a[0])
    np.testing.assert_array_equal(got[0], [xs.min(), ys.min(), xs.max(), ys.max()])


@pytest.mark.parametrize("thresh", [0.1, 0.5, 0.9])
def test_greedy_nms_matches_jax(thresh):
    """Random symmetric IoU matrices with tied scores: the same keep set."""
    rng = np.random.default_rng(2)
    iou = rng.random((12, 12)).astype(np.float32)
    iou = np.maximum(iou, iou.T)
    np.fill_diagonal(iou, 1.0)
    scores = np.round(rng.random(12), 1).astype(np.float32)  # ties
    want = np.asarray(jmasks.greedy_nms_from_iou(jnp.asarray(iou), jnp.asarray(scores), thresh))
    got = pmasks.greedy_nms_from_iou(_t(iou), _t(scores), thresh)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_masks_and_boxes_match_jax():
    rng = np.random.default_rng(4)
    m = np.zeros((6, 24, 32), bool)
    for i, (y, x) in enumerate([(2, 2), (3, 3), (12, 20), (2, 3), (12, 21), (18, 5)]):
        m[i, y:y + 8, x:x + 8] = True
    scores = rng.random(6).astype(np.float32)
    np.testing.assert_array_equal(
        pmasks.nms_masks(_t(m), _t(scores), 0.5).numpy(),
        np.asarray(jmasks.nms_masks(jnp.asarray(m), jnp.asarray(scores), 0.5)))
    boxes = pmasks.masks_to_boxes(_t(m))
    np.testing.assert_array_equal(
        pmasks.nms_boxes(boxes, _t(scores), 0.5).numpy(),
        np.asarray(jmasks.nms_boxes(jnp.asarray(boxes.numpy()), jnp.asarray(scores), 0.5)))


def _cc_masks():
    rng = np.random.default_rng(6)
    blobs = np.zeros((24, 32), bool)
    blobs[2:9, 3:12] = True
    blobs[4:6, 5:8] = False  # a hole
    blobs[12:20, 15:30] = True
    blobs[9, 12] = blobs[10, 13] = blobs[11, 14] = True  # a diagonal bridge (8-connectivity)
    snake = np.zeros((24, 32), bool)
    snake[::4] = True  # full rows joined at alternating ends: one long component
    for i, r in enumerate(range(0, 20, 4)):
        snake[r:r + 5, -1 if i % 2 == 0 else 0] = True
    return {"noise": rng.random((24, 32)) > 0.5, "blobs": blobs, "snake": snake,
            "empty": np.zeros((24, 32), bool), "full": np.ones((24, 32), bool)}


@pytest.mark.parametrize("name", ["noise", "blobs", "snake", "empty", "full"])
def test_connected_components_match_jax(name):
    """Labels are root index + 1 in both (the component's smallest linear
    index), so they compare exactly; areas too; the partition is scipy's."""
    mask = _cc_masks()[name]
    got = pcc.connected_components(_t(mask))
    want = np.asarray(jcc.connected_components(jnp.asarray(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pcc.component_areas(got).numpy(),
                                  np.asarray(jcc.component_areas(jnp.asarray(want))))
    ref, n = ndimage.label(mask, structure=EIGHT)
    assert len(set(zip(got.numpy()[mask].tolist(), ref[mask].tolist()))) == n


def _scores(seed=8):
    rng = np.random.default_rng(seed)
    s = ndimage.gaussian_filter(rng.standard_normal((3, 24, 32)), 1.5).astype(np.float32) * 8
    s[0, 5:9, 5:9] = 2.0
    s[0, 6, 6] = -1.0  # a one-pixel hole
    s[1, 20, 3] = 3.0  # a sprinkle
    return s


@pytest.mark.parametrize("sprinkles", [False, True])
def test_fill_holes_in_mask_scores_matches_jax(sprinkles):
    for s in _scores():
        got = pcc.fill_holes_in_mask_scores(_t(s), 6, sprinkles).numpy()
        want = np.asarray(jcc.fill_holes_in_mask_scores(jnp.asarray(s), 6, sprinkles))
        np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


@pytest.mark.parametrize("sprinkles", [False, True])
def test_fill_holes_host_scipy_path_matches_jax_host(sprinkles):
    """native=False (scipy, what the CPU tests of the pipeline run) against
    the JAX package's host function and the tensor version."""
    s = _scores(9)
    got = pcc.fill_holes_in_mask_scores_host(s, 6, sprinkles, native=False)
    np.testing.assert_array_equal(got, jcc.fill_holes_in_mask_scores_host(s, 6, sprinkles))
    tens = np.stack([pcc.fill_holes_in_mask_scores(_t(x), 6, sprinkles).numpy() for x in s])
    np.testing.assert_array_equal(got, tens)
    assert got is not s and (got != s).any()
    b4 = pcc.fill_holes_in_mask_scores_host(s[:, None], 6, sprinkles, native=False)
    assert b4.shape == (3, 1, 24, 32) and np.array_equal(b4[:, 0], got)


@pytest.mark.parametrize("sprinkles", [False, True])
def test_host_library_fill_holes_matches_scipy(host_lib, sprinkles):
    rng = np.random.default_rng(10)
    s = np.concatenate([_scores(11), rng.standard_normal((5, 24, 32)).astype(np.float32)])
    for area in (1, 6, 40):
        got = pcc.fill_holes_in_mask_scores_host(s, area, sprinkles, native=True)
        np.testing.assert_array_equal(
            got, pcc.fill_holes_in_mask_scores_host(s, area, sprinkles, native=False))
    with pytest.raises(ValueError, match="contiguous float32"):
        host_lib.fill_holes(s.astype(np.float64), 6)


def test_host_library_labels_nms_edt_match_references(host_lib):
    rng = np.random.default_rng(12)
    mask = rng.random((37, 53)) > 0.45
    labels, n = host_lib.cc_label(mask)
    ref, ref_n = ndimage.label(mask, structure=EIGHT)
    assert n == ref_n and np.array_equal(labels > 0, mask)
    assert len(set(zip(labels[mask].tolist(), ref[mask].tolist()))) == n
    iou = rng.random((9, 9)).astype(np.float32)
    iou = np.maximum(iou, iou.T)
    scores = rng.random(9).astype(np.float32)
    np.testing.assert_array_equal(
        host_lib.nms_greedy(iou, scores, 0.6),
        pmasks.greedy_nms_from_iou(_t(iou), _t(scores), 0.6).numpy())
    np.testing.assert_allclose(host_lib.edt(mask), ndimage.distance_transform_edt(mask),
                               atol=1e-4)
    with pytest.raises(ValueError, match="one .H, W. mask"):
        host_lib.edt(mask[None])


def test_host_library_record_store_roundtrip(host_lib, tmp_path):
    items = [bytes([i]) * 24 for i in range(5)]
    path = str(tmp_path / "store.bin")
    host_lib.RecordStore.write(path, items)
    store = host_lib.RecordStore(path)
    assert (store.count, store.item_size) == (5, 24)
    assert [store.read(i) for i in (4, 0, 2)] == [items[4], items[0], items[2]]
    with pytest.raises(IOError):
        store.read(5)
    with pytest.raises(IOError):
        host_lib.RecordStore(str(tmp_path / "missing.bin"))


@pytest.mark.parametrize("name", ["noise", "blobs", "full"])
def test_edt_matches_jax_and_scipy(name):
    """Distances are square roots of small integers in both: 1e-6."""
    mask = _cc_masks()[name]
    got = pedt.edt(_t(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(jedt.edt(jnp.asarray(mask))), rtol=1e-6, atol=0)
    if name != "full":  # with no zero pixel scipy has no answer; both give sqrt(1e9)
        np.testing.assert_allclose(got, ndimage.distance_transform_edt(mask), atol=1e-5)
    chunked = pedt.edt(_t(mask), chunk=5).numpy()
    np.testing.assert_array_equal(chunked, got)


def test_edt_batch():
    masks = np.stack([_cc_masks()[k] for k in ("noise", "blobs")])
    got = pedt.edt_batch(_t(masks))
    assert got.shape == (2, 24, 32)
    np.testing.assert_array_equal(got[1].numpy(), pedt.edt(_t(masks[1])).numpy())


@pytest.mark.parametrize("native", [False, True])
def test_click_sampling_matches_jax(native, request):
    """Host numpy in both packages, the same generator: equal outputs. The
    centre click is the argmax of the error region's distance transform,
    through the host library or the tensor version."""
    if native:
        request.getfixturevalue("host_lib")
    gt = np.zeros((24, 32), bool)
    gt[4:16, 6:20] = True
    pred = np.zeros((24, 32), bool)
    pred[8:20, 10:28] = True
    for fn in ("sample_box_points", "sample_random_points_from_errors"):
        args = (gt,) if fn == "sample_box_points" else (gt, pred, 3)
        got = getattr(pclicks, fn)(*args, rng=np.random.default_rng(1))
        want = getattr(jclicks, fn)(*args, rng=np.random.default_rng(1))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = pclicks.sample_center_point_from_errors(gt, pred, native=native)
    want = jclicks.sample_center_point_from_errors(gt, pred)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, labels = pclicks.sample_center_point_from_errors(gt, gt, native=native)
    assert labels[0] == -1  # no error region: a padding click


def test_frame_folder_loader(tmp_path):
    """The host-only loaders (a copy of the JAX package's): a folder of PNG
    frames comes back sorted, resized and as uint8."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(15)
    for i in (2, 0, 1):
        Image.fromarray(rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:05d}.png")
    files = pio.list_frame_files(str(tmp_path))
    assert [f[-9:] for f in files] == ["00000.png", "00001.png", "00002.png"]
    frames = pio.load_video_frames(str(tmp_path), resolution=16)
    assert np.asarray(frames).shape == (3, 16, 16, 3)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no image frames"):
        pio.list_frame_files(str(tmp_path / "empty"))
