"""Copy of efficientsam3_tpu/eval/fixtures.py.

Synthetic-but-nontrivial eval fixtures: colored geometric shapes on
noise, with gold-style COCO ground truth (one image entry per (image,
query) pair, `is_instance_exhaustive` flags, RLE segmentations).

Used by scripts/eval_quality.py and the model->evaluator end-to-end tests
to produce quality numbers (cgF1 / mask mAP / box-prompt mIoU) without
external datasets.
"""

from __future__ import annotations

import numpy as np

from efficientsam3_tpu_torch.eval.coco_format import mask_to_rle, rle_encode_string

QUERIES = ("a red square", "a blue disk")


def _draw_square(img, mask, cx, cy, r, color):
    y0, y1 = max(cy - r, 0), min(cy + r, img.shape[0])
    x0, x1 = max(cx - r, 0), min(cx + r, img.shape[1])
    img[y0:y1, x0:x1] = color
    mask[y0:y1, x0:x1] = True


def _draw_disk(img, mask, cx, cy, r, color):
    yy, xx = np.mgrid[: img.shape[0], : img.shape[1]]
    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    img[m] = color
    mask |= m


def make_shapes_fixture(num_images: int = 8, size: int = 112, seed: int = 0,
                        r_lo: int | None = None, r_hi: int | None = None):
    """Returns (images (N,H,W,3) uint8, gold_gt dict, pair list).

    Each image gets 0-3 red squares and 0-3 blue disks; per query there is
    one gold-style image entry (pair id = image_index * 2 + query_index).
    Shape half-size defaults to size//14 .. size//7 (the historical 8..16
    at size 112); pass r_lo/r_hi for larger/smaller objects.
    """
    rng = np.random.default_rng(seed)
    if r_lo is None:
        r_lo = max(size // 14, 4)
    if r_hi is None:
        r_hi = max(size // 7, r_lo + 2)
    margin = r_hi + 2
    images = []
    gt_images, gt_anns = [], []
    pairs = []  # (pair_id, image_index, query)
    ann_id = 1
    for i in range(num_images):
        img = rng.integers(60, 120, (size, size, 3), np.uint8)
        shape_masks = {q: [] for q in QUERIES}
        n_sq = int(rng.integers(0, 3))
        n_ds = int(rng.integers(0, 3))
        for _ in range(n_sq):
            m = np.zeros((size, size), bool)
            _draw_square(
                img, m, int(rng.integers(margin, size - margin)),
                int(rng.integers(margin, size - margin)),
                int(rng.integers(r_lo, r_hi)),
                (210, 40, 40),
            )
            shape_masks[QUERIES[0]].append(m)
        for _ in range(n_ds):
            m = np.zeros((size, size), bool)
            _draw_disk(
                img, m, int(rng.integers(margin, size - margin)),
                int(rng.integers(margin, size - margin)),
                int(rng.integers(max(r_lo - 1, 3), r_hi - 1)),
                (40, 60, 210),
            )
            shape_masks[QUERIES[1]].append(m)
        images.append(img)
        for qi, q in enumerate(QUERIES):
            pair_id = i * len(QUERIES) + qi
            gt_images.append(
                dict(
                    id=pair_id, file_name=f"img_{i}.png", height=size,
                    width=size, query=q, is_instance_exhaustive=True,
                    image_index=i,
                )
            )
            pairs.append((pair_id, i, q))
            for m in shape_masks[q]:
                ys, xs = np.nonzero(m)
                if not len(ys):
                    continue
                rle = mask_to_rle(m)
                rle["counts"] = rle_encode_string(rle["counts"])
                gt_anns.append(
                    dict(
                        id=ann_id, image_id=pair_id, category_id=1,
                        segmentation=rle, iscrowd=0, area=int(m.sum()),
                        bbox=[
                            float(xs.min()), float(ys.min()),
                            float(xs.max() - xs.min() + 1),
                            float(ys.max() - ys.min() + 1),
                        ],
                    )
                )
                ann_id += 1
    gt = dict(
        images=gt_images,
        annotations=gt_anns,
        categories=[dict(id=1, name="object")],
    )
    return np.stack(images), gt, pairs


def oracle_predict_fn(images, gt, jitter: float = 0.0, drop_prob: float = 0.0,
                      seed: int = 1):
    """A predictor stub returning (optionally corrupted) ground truth -
    validates the metric plumbing end-to-end (perfect input -> cgF1/mAP 1).
    """
    from efficientsam3_tpu_torch.eval.coco_format import ann_to_mask

    rng = np.random.default_rng(seed)
    by_pair = {}
    for a in gt["annotations"]:
        by_pair.setdefault(a["image_id"], []).append(a)
    info_by_id = {im["id"]: im for im in gt["images"]}

    def predict(img, phrase, pair_id):
        recs = []
        info = info_by_id[pair_id]
        h, w = info["height"], info["width"]
        for a in by_pair.get(pair_id, []):
            if rng.random() < drop_prob:
                continue
            m = ann_to_mask(a, h, w)
            if jitter > 0:
                m = np.roll(m, int(rng.normal(0, jitter)), axis=0)
            rle = mask_to_rle(m)
            rle["counts"] = rle_encode_string(rle["counts"])
            x, y, bw, bh = a["bbox"]
            recs.append(
                dict(
                    image_id=pair_id, category_id=1,
                    score=float(rng.uniform(0.8, 1.0)),
                    bbox=[x, y, bw, bh], segmentation=rle,
                )
            )
        return recs

    return predict
