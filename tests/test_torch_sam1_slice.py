"""The SAM1 slice of the PyTorch port against the JAX package, on the CPU
in fp32.

- ``SamStudentModel`` over a tiny ViT trunk (160^2, patch 16: a 10x10 grid,
  width 160 in 2 heads of 80, window 5, block 1 global, pretraining grid
  4) whose 10x10 map the antialiased resize takes down to the 8x8
  embedding, and over EfficientViT-b0 (128^2: a 4x4 map resized up to
  8x8): ``encode_image``, and ``SamStudentPredictor.predict`` with points,
  a box, and multimask output on and off.
- The batched NHWC form of the antialiased resize against
  ``jax.image.resize(..., "linear")`` in both directions.
- ``flash_sdpa_plain`` at head dim 80 against the Pallas ``_flash_fwd`` in
  interpret mode: ragged Lq and Lk, a masked key block, a batch row with
  every key masked, and the LSE.
- ``AutomaticMaskGenerator`` over the port's ``InteractiveImagePredictor``
  against JAX's over a tiny tracker (64x64 frames, d_model 32) with a
  synthetic image-dependent frame encoder: crop layers 0 and 1, ragged
  point batches, small-region cleanup; the records (count, order, RLE
  masks, boxes, scores, points, crop boxes).
- The ViT students at the registry's 1024^2 raise in both packages; the
  registry's keys and a full student's key map against JAX.

Weights are drawn with numpy over ``jax.eval_shape`` shapes and carried
across by ``utils/convert.py``.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu import automatic_mask_generator as jamg
from efficientsam3_tpu import student_sam as jss
from efficientsam3_tpu.eval import coco_format as jcf
from efficientsam3_tpu.models.vitdet import ViTTrunk as JViTTrunk
from efficientsam3_tpu.ops.pallas.flash_attention import _flash_fwd
from efficientsam3_tpu.sam1_task import InteractiveImagePredictor as JInteractive
from efficientsam3_tpu.video import tracker as jtr
from efficientsam3_tpu_torch import automatic_mask_generator as pamg
from efficientsam3_tpu_torch import student_sam as pss
from efficientsam3_tpu_torch.build import make_trunk
from efficientsam3_tpu_torch.eval import coco_format as pcf
from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased
from efficientsam3_tpu_torch.sam1_task import InteractiveImagePredictor
from efficientsam3_tpu_torch.utils.convert import converted_shapes, load_jax_variables
from efficientsam3_tpu_torch.video import tracker as ptr
from test_torch_sam1_trunks import random_variables
from test_torch_tracker_modules import CFG

# fp32 through a trunk, the neck, the two-way transformer and the upscaler,
# summed in other orders on XLA:CPU and ATen: of max(1, |largest|)
TOL = 1e-4
VIT = dict(patch_size=16, embed_dim=160, depth=2, num_heads=2, window_size=5,
           global_att_blocks=(1,), pretrain_grid=4, mlp_ratio=4.0)
PROMPTS = {
    "points": dict(point_coords=np.array([[60.0, 40.0], [20.0, 70.0]]),
                   point_labels=np.array([1, 0])),
    "box_single_mask": dict(box=np.array([15.0, 10.0, 120.0, 80.0]), multimask_output=False),
    "box_and_point": dict(box=np.array([15.0, 10.0, 120.0, 80.0]),
                          point_coords=np.array([[60.0, 40.0]]), point_labels=np.array([1])),
}


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@functools.lru_cache(maxsize=None)
def students(kind):
    """(JAX SamStudentPredictor, port SamStudentPredictor) over one set of
    weights, each holding the same image's embedding."""
    if kind == "vit":
        jtrunk, ptrunk, size = JViTTrunk(**VIT), ViTTrunk(**VIT), 160
    else:
        jtrunk, ptrunk, size = jss._make_trunk("efficientvit", "b0"), make_trunk(
            "efficientvit", "b0"), 128
    jm = jss.SamStudentModel(trunk=jtrunk, image_size=size, embed_size=8)
    init = functools.partial(jm.init, multimask_output=True)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, 2, 2)), jnp.zeros((1, 2), jnp.int32))
    variables = random_variables(shapes, seed=4)
    pm = load_jax_variables(pss.SamStudentModel(ptrunk, image_size=size, embed_size=8),
                            variables).requires_grad_(False).eval()
    image = np.random.default_rng(5).integers(0, 256, (96, 140, 3), dtype=np.uint8)
    jp, pp = jss.SamStudentPredictor(jm, variables), pss.SamStudentPredictor(pm)
    jp.set_image(image)
    pp.set_image(image)
    return jp, pp


@pytest.mark.parametrize("kind", ["vit", "cnn"])
def test_encode_image_matches_jax(kind):
    """The cached (1, 8, 8, 256) embedding: the ViT's 10x10 map resized
    down, b0's 4x4 map resized up (antialiased linear, as JAX)."""
    jp, pp = students(kind)
    assert pp._emb.shape == (1, 8, 8, 256) and pp._emb.dtype == torch.float32
    assert_close(pp._emb, jp._emb)


@pytest.mark.parametrize("kind,prompt", [("vit", "points"), ("vit", "box_single_mask"),
                                         ("cnn", "box_and_point")])
def test_student_predictor_matches_jax(kind, prompt):
    """SamStudentPredictor.predict: masks at the original 96x140, IoU
    predictions and the low-res logits; mask pixels are compared where the
    JAX logit upsampled there lies beyond 1e-2 of 0."""
    jp, pp = students(kind)
    kw = PROMPTS[prompt]
    jm, ji, jl = jp.predict(**kw)
    pm, pi, pl = pp.predict(**kw)
    n = 1 if kw.get("multimask_output") is False else 3
    assert pm.shape == jm.shape == (n, 96, 140) and pm.dtype == bool
    assert pl.shape == (n, 32, 32)
    np.testing.assert_allclose(pi, ji, atol=TOL, rtol=TOL)
    assert_close(pl, jl)
    hi = np.abs(np.asarray(jax.image.resize(jnp.asarray(jl), (n, 96, 140), "linear"))) > 1e-2
    assert np.array_equal(pm[hi], jm[hi])


@pytest.mark.parametrize("src,dst", [(70, 64), (10, 8), (32, 64), (4, 8)])
def test_nhwc_antialiased_resize_matches_jax(src, dst):
    """(2, src, src, 5) maps to dst x dst, down and up, against
    jax.image.resize's default (antialiased) linear resize (1e-5)."""
    x = np.random.default_rng(src).standard_normal((2, src, src, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 5), "linear")
    assert_close(resize_antialiased(torch.from_numpy(x), (dst, dst)), want, 1e-5)


def test_flash_sdpa_plain_d80_matches_pallas_kernel():
    """Head dim 80: Lq 100 and Lk 150 (ragged against the 64-row blocks),
    batch row 0 with keys 64-127 (a whole block, skipped) and the last 10
    masked, batch row 1 with every key masked (0 out, lse -1e9); output
    and LSE at 1e-5."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 2, n, 80)).astype(np.float32) for n in (100, 150, 150))
    bias = np.zeros((2, 150), np.float32)
    bias[0, 64:128] = fa.NEG_INF
    bias[0, 140:] = fa.NEG_INF
    bias[1] = fa.NEG_INF
    scale = 80 ** -0.5
    want, want_lse = _flash_fwd(*(jnp.asarray(a) for a in (q, k, v, bias)), scale, 64, 64,
                                True, return_lse=True)
    got, lse = fa.flash_sdpa_plain(*(torch.from_numpy(a) for a in (q, k, v, bias)), scale,
                                   return_lse=True)
    assert_close(got, want, 1e-5)
    assert_close(lse, want_lse, 1e-5)
    assert (got[1] == 0).all() and (lse[1] == fa.NEG_INF).all()
    assert fa.sdpa_kernel(torch.bfloat16, 80) == "flash_sdpa_h"  # the wgmma kernel
    assert fa.sdpa_kernel(torch.float32, 80) == "flash_sdpa_h_fp32"  # split bf16 parts


# --------------------------------------------------------------------------
# automatic mask generation over a tiny tracker


FS, D = 8, 32


@pytest.fixture(scope="module")
def amg_pair():
    """(JAX InteractiveImagePredictor, port InteractiveImagePredictor) over
    one tiny tracker and a synthetic frame encoder whose top level adds a
    fixed projection of the frame's 8x8 mean-pooled pixels."""
    jcore = jtr.TrackerCore(**CFG)
    shapes = jax.eval_shape(lambda key: jtr.init_tracker_variables(jcore, key),
                            jax.random.PRNGKey(0))
    tv = random_variables(shapes, seed=8)
    dec = tv["params"]["sam_mask_decoder"]
    # as tests/test_torch_pcs_slice.py: the object-score head's last bias + 10
    # (no mask replaced by "no object"); and the hypernetworks' last layers
    # x 30, so that seeded weights give mask logits of a few units, beyond
    # the stability offset of 1
    head = dec["pred_obj_score_head"]
    last = f"layers_{len(head) - 1}"
    head[last] = dict(head[last], bias=head[last]["bias"] + 10.0)
    for name, mlp in dec.items():
        if name.startswith("output_hypernetworks_mlps"):
            last = f"layers_{len(mlp) - 1}"
            mlp[last] = dict(mlp[last], kernel=mlp[last]["kernel"] * 30.0)
    pcore = load_jax_variables(ptr.TrackerCore(**CFG), tv).requires_grad_(False).eval()
    rng = np.random.default_rng(9)
    s0 = (0.1 * rng.standard_normal((1, 4 * FS, 4 * FS, D))).astype(np.float32)
    s1 = (0.1 * rng.standard_normal((1, 2 * FS, 2 * FS, D))).astype(np.float32)
    top = (0.1 * rng.standard_normal((1, FS, FS, D))).astype(np.float32)
    p0, p2 = (rng.standard_normal((3, D)).astype(np.float32) for _ in range(2))

    def features(img, mm):  # the finest and the top level follow the frame's colours
        fine = img.reshape(1, 4 * FS, 2, 4 * FS, 2, 3).mean((2, 4))
        coarse = img.reshape(1, FS, 8, FS, 8, 3).mean((2, 4))
        return mm(fine, 3.0 * p0), mm(coarse, p2)

    def jencode(img):
        f0, f2 = features(img, lambda a, b: a @ jnp.asarray(b))
        return {"sam2_fpn": [jnp.asarray(s0) + f0, jnp.asarray(s1), jnp.asarray(top) + f2]}

    def pencode(img):
        f0, f2 = features(img, lambda a, b: a @ torch.from_numpy(b))
        return {"sam2_fpn": [torch.from_numpy(s0) + f0, torch.from_numpy(s1),
                             torch.from_numpy(top) + f2]}

    return JInteractive(jcore, tv, jencode), InteractiveImagePredictor(pcore, pencode)


def _image():
    img = np.full((90, 120, 3), 40, np.uint8)
    img[20:60, 30:80] = (220, 180, 60)
    img[65:85, 90:115] = (30, 200, 230)
    return img


@pytest.mark.parametrize("crop_n_layers,min_mask_area", [(0, 0), (1, 30)])
def test_automatic_mask_generator_matches_jax(amg_pair, crop_n_layers, min_mask_area):
    """Records of generate() on a 90x120 image: a 4x4 grid in batches of 6
    (ragged), IoU threshold 0.3 and stability threshold 0.5 (seeded
    weights), crop layer 1 (4 overlapping crops, each with the same score
    under cross-crop NMS: ties go by index) and small-region cleanup at 30
    pixels. Count, order, crop boxes and points equal; RLE masks equal
    but for pixels whose upsampled logit lies within rounding of 0 (at
    most 0.5% of a mask's area); boxes within a pixel; predicted IoU at
    1e-4, stability at 2e-2 (a pixel count near the offset may flip)."""
    jp, pp = amg_pair
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.3,
              stability_score_thresh=0.5, crop_n_layers=crop_n_layers,
              min_mask_area=min_mask_area)
    image = _image()
    want = jamg.AutomaticMaskGenerator(jp, **kw).generate(image)
    got = pamg.AutomaticMaskGenerator(pp, **kw).generate(image)
    assert len(want) > 2 and len(got) == len(want)
    if crop_n_layers:
        assert len({tuple(r["crop_box"]) for r in want}) > 1
    for g, w in zip(got, want):
        assert g["crop_box"] == w["crop_box"]
        np.testing.assert_allclose(g["point_coords"], w["point_coords"])
        gm, wm = rle_to_mask(g["segmentation"]), rle_to_mask(w["segmentation"])
        assert gm.shape == wm.shape == image.shape[:2]
        assert (gm != wm).sum() <= 0.005 * w["area"], (gm != wm).sum()
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1.0)
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"], atol=TOL)
        np.testing.assert_allclose(g["stability_score"], w["stability_score"], atol=2e-2)


def test_amg_helpers_match_jax():
    """Point grids, crop boxes of two layers on a non-square image, the
    crop-edge test, small-region removal on a mask with a small hole and a
    small island, and that mask's RLE (counts and compressed string)."""
    for g, w in zip(pamg.build_all_layer_point_grids(8, 2, 2),
                    jamg.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(g, w)
    assert pamg.generate_crop_boxes((90, 120), 2, 512 / 1500) == jamg.generate_crop_boxes(
        (90, 120), 2, 512 / 1500)
    boxes = np.array([[0, 0, 10, 10], [50, 5, 60, 40], [30, 30, 59, 44], [2, 2, 40, 40]],
                     np.float32)
    np.testing.assert_array_equal(
        pamg.is_box_near_crop_edge(boxes, [60, 0, 120, 45], [0, 0, 120, 90]),
        jamg.is_box_near_crop_edge(boxes, [60, 0, 120, 45], [0, 0, 120, 90]))
    m = np.zeros((30, 40), bool)
    m[5:25, 5:30] = True
    m[10:12, 10:12] = False  # a 4-pixel hole
    m[27:29, 35:37] = True  # a 4-pixel island
    for mode in ("holes", "islands"):
        g, gc = pamg._remove_small_regions(m, 10, mode)
        w, wc = jamg._remove_small_regions(m, 10, mode)
        assert gc == wc and np.array_equal(g, w)
    rle = pcf.mask_to_rle(m)  # the port's copy of eval/coco_format.py
    assert rle == jcf.mask_to_rle(m) and np.array_equal(pcf.rle_to_mask(rle), m)
    s = pcf.rle_encode_string(rle["counts"])
    assert s == jcf.rle_encode_string(rle["counts"]) and pcf.rle_decode_string(s) == rle["counts"]


# --------------------------------------------------------------------------
# registry


def test_vit_students_at_1024_raise_in_both_packages():
    """vit_b at its registry size: the 64x64 token grid does not split into
    14-token windows; JAX asserts while tracing, the port raises at the
    first windowed block (built and run on ``meta``)."""
    jm = jss.build_sam_vit_student("vit_b")
    init = functools.partial(jm.init, multimask_output=True)
    with pytest.raises(AssertionError, match="divisible"):
        jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1024, 3)),
                       jnp.zeros((1, 2, 2)), jnp.zeros((1, 2), jnp.int32))
    pm = pss.sam_model_registry["vit_b"](device="meta")
    with pytest.raises(ValueError, match="14x14 windows"):
        pm.encode_image(torch.zeros((1, 1024, 1024, 3), device="meta"))


def test_registry_keys_and_student_key_map_match_jax():
    """The registry's eight keys; EdgeSAM (RepViT-M1.1 under the SAM1
    heads) on ``meta`` against ``jax.eval_shape`` of the JAX student's
    ``init`` (batch_stats included), both ways; and without a card the
    builders raise rather than build on the CPU."""
    assert set(pss.sam_model_registry) == set(jss.sam_model_registry)
    jm = jss.sam_model_registry["edge_sam"]()
    init = functools.partial(jm.init, multimask_output=True)
    want = converted_shapes(jax.eval_shape(
        init, jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1024, 3)), jnp.zeros((1, 2, 2)),
        jnp.zeros((1, 2), jnp.int32)))
    pm = pss.sam_model_registry["edge_sam"](device="meta")
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert sorted(got.keys() ^ want.keys()) == [] and got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pss.sam_model_registry["tinyvit"]()
