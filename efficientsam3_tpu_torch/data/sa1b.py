"""Stage-1 distillation data pipeline (numpy only).

Counterpart of efficientsam3_tpu/data/sa1b.py, the reference's SA-1B
distillation data design (stage1/data/):
  - each sample pairs an image with a STORED teacher embedding record of
    [4-byte aug seed | fp16 embedding] (dataset_wrapper.py:50-61), so the
    student replays the exact augmentation the teacher saw;
  - the byte store is a fixed-item-size keyed file, the port's
    ``native.RecordStore`` (the C++ reader of csrc/hostkernels.cu);
  - images are padded to square then resized (sa1b_dataset.py:19).

PIL is imported inside the functions that decode or resize images, so a
caller that brings its own images (the teacher export on the card, where
no PIL is installed) never loads it. Batches are numpy; the caller moves
them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

MEAN = 0.5
STD = 0.5


def pad_to_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = max(h, w)
    out = np.zeros((s, s, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out


def replayed_augment(img: np.ndarray, seed: int, out_size: int) -> np.ndarray:
    """Deterministic augmentation replayed from the stored seed: horizontal
    flip + scale jitter crop, then pad-to-square + bilinear resize (PIL),
    normalised to (x - 0.5) / 0.5."""
    rng = np.random.default_rng(seed)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    scale = 0.8 + 0.4 * rng.random()
    h, w = img.shape[:2]
    ch, cw = max(1, int(h * scale)), max(1, int(w * scale))
    if ch < h or cw < w:
        y0 = rng.integers(0, h - ch + 1)
        x0 = rng.integers(0, w - cw + 1)
        img = img[y0:y0 + ch, x0:x0 + cw]
    img = pad_to_square(img)
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8))
    pil = pil.resize((out_size, out_size), Image.BILINEAR)
    arr = np.asarray(pil, np.float32) / 255.0
    return (arr - MEAN) / STD


class SA1BDistillationDataset:
    """Pairs image files with stored teacher-embedding records: item i is
    {image (S, S, 3) f32, teacher (E, E, C) f32, valid (E, E) f32}."""

    RECORD_HEADER = 4  # uint32 aug seed

    def __init__(self, image_paths: Sequence[str], store_path: str, image_size: int = 1008,
                 embed_dim: int = 1024, embed_size: int = 72):
        from efficientsam3_tpu_torch.native import RecordStore

        self.image_paths = list(image_paths)
        self.store = RecordStore(store_path)
        if self.store.count != len(self.image_paths):
            raise ValueError(f"{self.store.count} records for {len(self.image_paths)} images")
        self.image_size = image_size
        self.embed_dim = embed_dim
        self.embed_size = embed_size
        expected = self.RECORD_HEADER + 2 * embed_dim * embed_size * embed_size
        if self.store.item_size != expected:
            raise ValueError(f"record size {self.store.item_size}, want {expected}")

    def __len__(self):
        return len(self.image_paths)

    def record(self, idx: int):
        """(aug seed, (E, E, C) f32 teacher embedding) of record idx."""
        raw = self.store.read(idx)
        seed = int(np.frombuffer(raw[:4], np.uint32)[0])
        embed = (np.frombuffer(raw[4:], np.float16)
                 .reshape(self.embed_size, self.embed_size, self.embed_dim)
                 .astype(np.float32))
        return seed, embed

    def __getitem__(self, idx: int):
        from PIL import Image

        seed, embed = self.record(idx)
        img = np.asarray(Image.open(self.image_paths[idx]).convert("RGB"))
        orig_h, orig_w = img.shape[:2]
        img = replayed_augment(img, seed, self.image_size)
        # valid mask from pre-pad content size (train_image_encoder_stage1.py:271)
        s = max(orig_h, orig_w)
        vh = max(1, round(self.embed_size * orig_h / s))
        vw = max(1, round(self.embed_size * orig_w / s))
        valid = np.zeros((self.embed_size, self.embed_size), np.float32)
        valid[:vh, :vw] = 1.0
        return {"image": img, "teacher": embed, "valid": valid}

    @staticmethod
    def write_records(store_path: str, seeds, embeddings):
        """Write [seed | fp16 embedding] records (teacher export)."""
        from efficientsam3_tpu_torch.native import RecordStore

        items = [np.uint32(seed).tobytes() + np.asarray(emb, np.float16).tobytes()
                 for seed, emb in zip(seeds, embeddings)]
        RecordStore.write(store_path, items)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   epochs: Optional[int] = None, prefetch: int = 2) -> Iterator[dict]:
    """Threaded prefetching batch loader: each epoch a (seeded) permutation
    of the dataset in full batches, every key stacked."""

    def producer(q):
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(dataset))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                samples = [dataset[int(j)] for j in order[i:i + batch_size]]
                q.put({k: np.stack([s[k] for s in samples]) for k in samples[0]})
            epoch += 1
        q.put(None)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    threading.Thread(target=producer, args=(q,), daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        yield item


def export_teacher_embeddings(teacher_apply, image_paths: Sequence[str], store_path: str,
                              image_size: int = 1008, batch_size: int = 4, seed: int = 0):
    """One-pass teacher export (reference stage1/save_embedding_image_stage1.py).

    teacher_apply: callable(images (B, S, S, 3) f32 numpy) -> (B, E, E, C)
    embeddings (numpy, or anything ``np.asarray`` takes). Each record
    stores the augmentation seed used, so training replays it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32 - 1, size=len(image_paths), dtype=np.uint32)
    items_seeds, items_embeds = [], []
    for i in range(0, len(image_paths), batch_size):
        chunk = image_paths[i:i + batch_size]
        imgs = []
        for j, p in enumerate(chunk):
            raw = np.asarray(Image.open(p).convert("RGB"))
            imgs.append(replayed_augment(raw, int(seeds[i + j]), image_size))
        embeds = np.asarray(teacher_apply(np.stack(imgs)))
        for j in range(len(chunk)):
            items_seeds.append(int(seeds[i + j]))
            items_embeds.append(embeds[j])
    SA1BDistillationDataset.write_records(store_path, items_seeds, items_embeds)
