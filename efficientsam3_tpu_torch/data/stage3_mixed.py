"""Stage-3 mixed multi-source detection dataset.

Mirrors the reference Stage3MixedTextMaskDataset (stage3/data/
mixed_text_mask_dataset.py:424): multiple COCO-format sources (COCO, LVIS,
ODinW, RF100-VL, ...) plus RefCOCO-style parquet phrase-grounding sources
(:156-350 _RefCocoParquetSource) are sampled by weight; each example is an
(image, text prompt, instances) find-query with padded fixed-width targets
ready for train/losses.py.

Augmentations (data/transforms.py: hflip, large-scale jitter, color jitter,
query filtering - reference train/transforms/basic_for_api.py) run on host
at native resolution; `pad_to_fixed` keeps the device-step shapes static.

A copy of efficientsam3_tpu/data/stage3_mixed.py for the port, over its
``data.transforms`` and ``eval.coco_format``; PIL and pandas are imported
only where an image or a parquet file is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from efficientsam3_tpu_torch.data import transforms as T
from efficientsam3_tpu_torch.eval.coco_format import CocoDataset, ann_to_mask


@dataclasses.dataclass
class Source:
    name: str
    dataset: CocoDataset
    image_root: str
    weight: float = 1.0


class RefCocoParquetSource:
    """RefCOCO-style phrase-grounding rows from parquet files (reference
    stage3/data/mixed_text_mask_dataset.py:156 _RefCocoParquetSource).

    Expected columns (flexible names): a phrase ('phrase'/'sentence'/
    'caption'/'query'), a box ('bbox' xywh) and/or RLE mask
    ('segmentation'), and an image path ('file_name'/'image_path') relative
    to image_root.
    """

    PHRASE_COLS = ("phrase", "sentence", "caption", "query", "text")
    IMAGE_COLS = ("file_name", "image_path", "image", "img_path")

    def __init__(self, parquet_paths, image_root: str = "", name: str = "refcoco",
                 weight: float = 1.0, max_rows: Optional[int] = None):
        import pandas as pd

        if isinstance(parquet_paths, (str, os.PathLike)):
            parquet_paths = [parquet_paths]
        frames = [pd.read_parquet(p) for p in parquet_paths]
        self.df = pd.concat(frames, ignore_index=True) if frames else None
        if max_rows is not None and self.df is not None:
            self.df = self.df.iloc[:max_rows]
        self.image_root = image_root
        self.name = name
        self.weight = weight
        cols = set(self.df.columns) if self.df is not None else set()
        self.phrase_col = next((c for c in self.PHRASE_COLS if c in cols), None)
        self.image_col = next((c for c in self.IMAGE_COLS if c in cols), None)
        if self.df is not None and (self.phrase_col is None or self.image_col is None):
            raise ValueError(f"unrecognized parquet schema: {sorted(cols)}")

    def __len__(self):
        return 0 if self.df is None else len(self.df)

    def load(self, idx: int):
        """Returns (image uint8, phrase, boxes xyxy abs (N,4), masks or None)."""
        from PIL import Image

        row = self.df.iloc[idx]
        img = Image.open(
            os.path.join(self.image_root, str(row[self.image_col]))
        ).convert("RGB")
        img = np.asarray(img)
        h, w = img.shape[:2]
        boxes, masks = [], []
        if "segmentation" in row and row["segmentation"] is not None:
            seg = row["segmentation"]
            if isinstance(seg, (bytes, str)):
                import json

                seg = json.loads(seg)
            m = ann_to_mask({"segmentation": seg}, h, w)
            masks.append(m)
            ys, xs = np.nonzero(m)
            if len(ys):
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        if not boxes and "bbox" in row and row["bbox"] is not None:
            x, y, bw, bh = [float(v) for v in row["bbox"]]
            boxes.append([x, y, x + bw, y + bh])
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        masks = np.stack(masks) if masks else None
        return img, str(row[self.phrase_col]), boxes, masks


class Stage3MixedDataset:
    """Sampled (image, prompt, targets) find-queries across sources."""

    def __init__(
        self,
        sources: Sequence[Source],
        image_size: int = 1008,
        max_targets: int = 40,
        mask_size: Optional[int] = 288,
        negative_prompt_prob: float = 0.2,
        seed: int = 0,
        augment: bool = False,
        phrase_sources: Sequence[RefCocoParquetSource] = (),
    ):
        self.sources = list(sources)
        self.phrase_sources = list(phrase_sources)
        self.image_size = image_size
        self.max_targets = max_targets
        self.mask_size = mask_size
        self.negative_prompt_prob = negative_prompt_prob
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        # (source_idx, image_id, category_id) triples with >=1 instance, plus
        # (-1 - phrase_source_idx, row, None) entries for phrase sources
        self.queries = []
        weights = []
        for si, src in enumerate(self.sources):
            for img_id in src.dataset.images:
                cats = {a["category_id"] for a in src.dataset.annotations(img_id)}
                for c in cats:
                    self.queries.append((si, img_id, c))
                    weights.append(src.weight)
        for pi, src in enumerate(self.phrase_sources):
            for row in range(len(src)):
                self.queries.append((-1 - pi, row, None))
                weights.append(src.weight)
        weights = np.asarray(weights, np.float64)
        self.probs = weights / weights.sum()

    def __len__(self):
        return len(self.queries)

    def _load_image_raw(self, src: Source, info: dict) -> np.ndarray:
        from PIL import Image

        path = os.path.join(src.image_root, info["file_name"])
        return np.asarray(Image.open(path).convert("RGB"))

    def _raw_sample(self):
        """Returns (image uint8 native res, prompt, boxes xyxy abs, masks,
        source_name)."""
        qi = self.rng.choice(len(self.queries), p=self.probs)
        si, img_id, cat_id = self.queries[qi]
        if si < 0:
            src = self.phrase_sources[-1 - si]
            img, phrase, boxes, masks = src.load(img_id)
            return img, phrase, boxes, masks, src.name
        src = self.sources[si]
        info = src.dataset.images[img_id]
        h, w = info["height"], info["width"]
        image = self._load_image_raw(src, info)

        # with some probability turn this into a NEGATIVE query: prompt a
        # category absent from the image (trains the presence head)
        negative = self.rng.random() < self.negative_prompt_prob
        if negative:
            present = {a["category_id"] for a in src.dataset.annotations(img_id)}
            absent = [c for c in src.dataset.categories if c not in present]
            if absent:
                cat_id = int(self.rng.choice(absent))
        prompt_text = src.dataset.categories[cat_id]["name"]

        anns = [] if negative else src.dataset.annotations(img_id, cat_id)
        boxes, masks = [], []
        want_masks = self.mask_size is not None
        for ann in anns:
            x, y, bw, bh = ann["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            if want_masks and "segmentation" in ann:
                masks.append(ann_to_mask(ann, h, w))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        masks = (
            np.stack(masks)
            if masks and len(masks) == len(boxes)
            else (np.zeros((0, h, w), bool) if want_masks else None)
        )
        if masks is not None and len(masks) != len(boxes):
            masks = None
        return image, prompt_text, boxes, masks, src.name

    def sample(self) -> dict:
        image, prompt_text, boxes, masks, src_name = self._raw_sample()
        s = {"image": image, "boxes": boxes, "masks": masks}
        if self.augment:
            s = T.keep_max_targets(s, self.rng, self.max_targets)
            s = T.stage3_train_augment(s, self.rng, self.image_size)
        else:
            s = T.resize(s, self.image_size, square=True)
        s = T.pad_to_fixed(
            T.normalize(s), self.max_targets, self.mask_size
        )
        out = {
            "image": s["image"].astype(np.float32),
            "prompt_text": prompt_text,
            "boxes": s["boxes"],
            "valid": s["valid"],
            "source": src_name,
        }
        if self.mask_size is not None:
            out["masks"] = s["masks"]
        return out

    def batches(self, tokenizer, batch_size: int, context_length: int = 32):
        """Infinite batch iterator with tokenized prompts."""
        while True:
            samples = [self.sample() for _ in range(batch_size)]
            yield {
                "images": np.stack([s["image"] for s in samples]),
                "tokens": tokenizer(
                    [s["prompt_text"] for s in samples], context_length
                ),
                "targets": {
                    "boxes": np.stack([s["boxes"] for s in samples]),
                    "valid": np.stack([s["valid"] for s in samples]),
                    **(
                        {"masks": np.stack([s["masks"] for s in samples])}
                        if "masks" in samples[0]
                        else {}
                    ),
                },
            }
