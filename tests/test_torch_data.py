"""The port's copies of the Stage-3 data modules (``data.transforms``,
``data.stage3_mixed``, ``data.engine``) against the JAX package's: JAX's
scenarios of tests/test_data_transforms.py and
tests/test_stage3_data_postprocess.py (the Stage-3 dataset's; the
postprocessors are eval code, not ported yet) run on both, with every
output equal, and the checks of those tests held on the port's outputs.
"""

import json

import numpy as np
import pytest

from efficientsam3_tpu.data import engine as JE
from efficientsam3_tpu.data import stage3_mixed as JS
from efficientsam3_tpu.data import transforms as JT
from efficientsam3_tpu.eval.coco_format import CocoDataset as JCoco
from efficientsam3_tpu_torch.data import engine as PE
from efficientsam3_tpu_torch.data import stage3_mixed as PS
from efficientsam3_tpu_torch.data import transforms as PT
from efficientsam3_tpu_torch.eval.coco_format import CocoDataset as PCoco


def _sample(seed=0, h=96, w=128, n=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), np.uint8)
    masks = np.zeros((n, h, w), bool)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        y0 = int(rng.integers(0, h - 24))
        x0 = int(rng.integers(0, w - 24))
        bh = int(rng.integers(12, 24))
        bw = int(rng.integers(12, 24))
        masks[i, y0:y0 + bh, x0:x0 + bw] = True
        boxes[i] = [x0, y0, x0 + bw, y0 + bh]
    return {"image": img, "boxes": boxes, "masks": masks}


def _assert_consistent(s, atol):
    """Transformed boxes still bound the transformed masks."""
    if not len(s["boxes"]):
        return
    from_masks = np.asarray([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
                             for ys, xs in (np.nonzero(m) for m in s["masks"])], np.float32)
    np.testing.assert_allclose(s["boxes"], from_masks, atol=atol)


def assert_same(got, want):
    """Equal structure, dtypes and values (numpy arrays, dicts, lists,
    scalars, strings)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (type(got), want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def both(name, *args, seed=None, **kw):
    """T.<name>(*args) of each package (each with its own numpy generator
    from ``seed``, passed after the args); the port's output, checked equal
    to JAX's."""
    extra = (lambda: (np.random.default_rng(seed),)) if seed is not None else (lambda: ())
    want = getattr(JT, name)(*args, *extra(), **kw)
    got = getattr(PT, name)(*args, *extra(), **kw)
    assert_same(got, want)
    return got


def test_hflip():
    s = _sample()
    f = both("hflip", s)
    _assert_consistent(f, atol=1e-6)
    assert np.array_equal(PT.hflip(f)["image"], s["image"])


def test_resize():
    s = _sample()
    r = both("resize", s, 64)
    assert min(r["image"].shape[:2]) == 64
    _assert_consistent(r, atol=2.0)
    sq = both("resize", s, 80, square=True)
    assert sq["image"].shape[:2] == (80, 80)
    _assert_consistent(sq, atol=2.0)


def test_crop():
    c = both("crop", _sample(), 10, 20, 60, 70)
    assert c["image"].shape[:2] == (60, 70) and len(c["boxes"]) == len(c["masks"])
    _assert_consistent(c, atol=1.5)
    assert (c["boxes"][:, 0::2] <= 70).all() and (c["boxes"][:, 1::2] <= 60).all()


@pytest.mark.parametrize("seed", range(4))
def test_large_scale_jitter(seed):
    j = both("large_scale_jitter", _sample(seed), seed=3 + seed, out_size=96)
    assert j["image"].shape[:2] == (96, 96)
    if len(j["boxes"]):
        assert len(j["boxes"]) == len(j["masks"])
        _assert_consistent(j, atol=2.5)


def test_point_sampling():
    """center_positive_sample runs the port's tensor EDT and returns numpy
    float32 clicks, as JAX's does."""
    s = _sample()
    m = s["masks"][0]
    pts = both("uniform_positive_sample", m, 8, seed=0)
    assert pts.shape == (8, 3) and all(m[int(y), int(x)] for x, y, _ in pts)
    for n in (1, 2, 5):
        cpts = both("center_positive_sample", m, n)
        assert cpts.shape == (n, 3) and all(m[int(y), int(x)] for x, y, _ in cpts)
    bpts = both("uniform_sample_from_box", m, s["boxes"][0], 16, seed=0)
    for x, y, lab in bpts:
        assert lab == m[int(y) if y < m.shape[0] else -1, int(x) if x < m.shape[1] else -1]


def test_randomize_box():
    for i in range(20):
        b = both("randomize_box", np.asarray([10.0, 10.0, 50.0, 40.0]), seed=i,
                 img_hw=(96, 128))
        assert 0 <= b[0] <= b[2] <= 128 and 0 <= b[1] <= b[3] <= 96


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_pipeline_and_pad_to_fixed(seed):
    s = _sample(seed)
    jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = JT.pad_to_fixed(JT.normalize(JT.stage3_train_augment(s, jrng, image_size=96)),
                           max_targets=8, mask_size=32)
    fin = PT.pad_to_fixed(PT.normalize(PT.stage3_train_augment(s, prng, image_size=96)),
                          max_targets=8, mask_size=32)
    assert_same(fin, want)
    assert fin["image"].shape == (96, 96, 3) and fin["masks"].shape == (8, 32, 32)
    n = int(fin["valid"].sum())
    if n:
        assert (fin["boxes"][:n, 2:] > 0).all() and (fin["boxes"][:n] <= 1.0 + 1e-6).all()
    assert not fin["valid"][n:].any()


def _toy_coco(tmp_path, name, n_imgs=3):
    from PIL import Image

    root = tmp_path / name
    root.mkdir()
    images, anns = [], []
    rng = np.random.default_rng(sum(map(ord, name)))
    for i in range(n_imgs):
        fn = f"{i}.png"
        Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(root / fn)
        images.append({"id": i, "file_name": fn, "height": 40, "width": 50})
        anns.append({"id": i + 1, "image_id": i, "category_id": 1 + (i % 2),
                     "bbox": [5, 5, 20, 15], "segmentation": [[5, 5, 25, 5, 25, 20, 5, 20]],
                     "iscrowd": 0})
    d = {"images": images, "annotations": anns,
         "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]}
    return d, str(root)


def _tok(texts, ctx):
    return np.zeros((len(texts), ctx), np.int32)


@pytest.mark.parametrize("augment", [False, True])
def test_stage3_mixed_dataset(tmp_path, augment):
    """Two weighted COCO-format sources: every sample and batch equal to
    JAX's from the same seed, shaped as JAX's test checks."""
    d1, root1 = _toy_coco(tmp_path, "src1")
    d2, root2 = _toy_coco(tmp_path, "src2")
    kw = dict(image_size=64, max_targets=4, mask_size=16, seed=1 + augment, augment=augment)
    if augment:
        kw["negative_prompt_prob"] = 0.0
    mixed = {}
    for S, C in ((JS, JCoco), (PS, PCoco)):
        mixed[S] = S.Stage3MixedDataset(
            [S.Source("a", C(json.loads(json.dumps(d1))), root1, 1.0),
             S.Source("b", C(json.loads(json.dumps(d2))), root2, 2.0)], **kw)
    assert len(mixed[PS]) == 6
    for _ in range(6):
        s = mixed[PS].sample()
        assert_same(s, mixed[JS].sample())
        assert s["image"].shape == (64, 64, 3) and s["boxes"].shape == (4, 4)
        n = int(s["valid"].sum())
        if n:
            assert (s["boxes"][:n] >= -1e-6).all() and (s["boxes"][:n] <= 1 + 1e-6).all()
            assert s["masks"][:n].sum() > 0
    got = next(mixed[PS].batches(_tok, batch_size=2, context_length=8))
    assert_same(got, next(mixed[JS].batches(_tok, batch_size=2, context_length=8)))
    assert got["images"].shape == (2, 64, 64, 3)
    assert got["targets"]["boxes"].shape == (2, 4, 4)


def test_refcoco_parquet_source(tmp_path):
    import pandas as pd
    from PIL import Image

    root = tmp_path / "ref"
    root.mkdir()
    Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(root / "r0.png")
    df = pd.DataFrame({"phrase": ["the red thing", "a dog"],
                       "file_name": ["r0.png", "r0.png"],
                       "bbox": [[5.0, 5.0, 20.0, 15.0], [2.0, 2.0, 10.0, 10.0]]})
    pq = root / "anno.parquet"
    df.to_parquet(pq)
    out = {}
    for S in (JS, PS):
        src = S.RefCocoParquetSource(str(pq), image_root=str(root), weight=3.0)
        assert len(src) == 2
        loaded = src.load(0)
        assert loaded[1] == "the red thing" and loaded[2].shape == (1, 4)
        mixed = S.Stage3MixedDataset([], image_size=64, max_targets=4, mask_size=None, seed=0,
                                     phrase_sources=[src])
        out[S] = (loaded, mixed.sample())
    assert_same(out[PS], out[JS])
    assert isinstance(out[PS][1]["prompt_text"], str) and out[PS][1]["valid"].sum() == 1


def test_engine_copy_matches_jax():
    """JAX's engine scenarios (tests/test_data_engine.py) on the copy: stub
    labels, grouped queries, audit, the COCO export read by the port's
    CocoDataset, and the rejection paths, each equal to JAX's."""
    rs = np.random.RandomState(0)
    sample = {"image_id": 7, "width": 120, "height": 100,
              "image": rs.randint(0, 255, (100, 120, 3), np.uint8),
              "masks": [{"mask_id": "m0", "bbox_xywh": [5, 5, 40, 10], "area": 300},
                        {"mask_id": "m1", "bbox_xywh": [60, 50, 40, 10], "area": 280},
                        {"mask_id": "m2", "bbox_xywh": [10, 60, 8, 30], "area": 150}]}

    def bad_vlm(crop, system, user):
        return json.dumps({"label": "object", "confidence": 0.9})

    out = {}
    for E in (JE, PE):
        recs = E.label_masks([sample], vlm=E.stub_vlm)
        out[E] = (recs, E.build_grouped_queries(recs, strategy="distinct"),
                  E.build_grouped_queries(recs, strategy="merge"), E.audit(recs),
                  E.records_to_coco(recs), E.label_masks([sample], vlm=bad_vlm),
                  E.label_masks([sample], vlm=E.stub_vlm, min_area_frac=0.5))
    assert_same(out[PE], out[JE])
    recs, distinct, _, stats, coco, bad, small = out[PE]
    assert "wide" in recs[0]["label"] and "tall" in recs[2]["label"]
    assert len({q["query_text"] for q in distinct[7]["queries"]}) == 3
    assert stats["num_accepted"] == 3 and len(PCoco(coco).annotations(7)) == 3
    assert all(r["reject_reason"] == "generic label" for r in bad)
    assert all(r["reject_reason"] == "mask too small" for r in small)
