"""Pieces the port's entry points share: the ``--device`` flag, image
folders and files, the synthetic byte-level BPE file, and writers of the
small inputs the entry points read (the shapes fixture as a COCO dataset,
a video in eval_video's format), with which the tests and chip_smoke.py
drive them."""

from __future__ import annotations

import glob
import gzip
import os

# A CLIP merge table with its header line and no merges: every byte is a
# token (ids 0-511), <|startoftext|> 512 and <|endoftext|> 513. It stands
# in for bpe_simple_vocab_16e6.txt.gz, which is not in the repository.
BYTE_LEVEL_BPE = "#version: 0.2 (byte-level, no merges)"


def add_device_flag(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs on the host)")


def write_byte_level_bpe(path: str) -> str:
    """Write the merge table BYTE_LEVEL_BPE, gzipped, to ``path``."""
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(BYTE_LEVEL_BPE)
    return path


def image_paths(images_dir: str) -> list:
    """The folder's .jpg and .png files, sorted as the JAX scripts sort them."""
    return sorted(glob.glob(os.path.join(images_dir, "*.jpg"))
                  + glob.glob(os.path.join(images_dir, "*.png")))


def model_resolution(image_model) -> int:
    """The input side of an EfficientSAM3 image model: 14 pixels a token of
    its trunk's embed_size x embed_size map (1008 at the default 72)."""
    return image_model.trunk.head.embed_size * 14


def load_rgb(path: str):
    """An image file as an (H, W, 3) uint8 array."""
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_rgb(path: str, image) -> str:
    """Write an (H, W, 3) uint8 array as an image file (PNG by its name)."""
    from PIL import Image

    Image.fromarray(image).save(path)
    return path


def write_shapes_coco(root: str, num_images: int = 4, size: int = 112, seed: int = 3,
                      **fixture_kw) -> str:
    """``eval.fixtures.make_shapes_fixture`` on disk as a COCO dataset the
    entry points read: PNGs ``img_<i>.png`` under ``root`` and
    ``root/coco.json`` with one category a query ("a red square", "a blue
    disk") and the annotations of each image. Returns the json's path."""
    import json

    from efficientsam3_tpu_torch.eval.fixtures import QUERIES, make_shapes_fixture

    images, gt, pairs = make_shapes_fixture(num_images=num_images, size=size, seed=seed,
                                            **fixture_kw)
    os.makedirs(root, exist_ok=True)
    info = {i: dict(id=i, file_name=f"img_{i}.png", height=size, width=size)
            for _, i, _ in pairs}
    for i in info:
        save_rgb(os.path.join(root, info[i]["file_name"]), images[i])
    cat_of_pair = {pair_id: QUERIES.index(q) + 1 for pair_id, _, q in pairs}
    image_of_pair = {pair_id: i for pair_id, i, _ in pairs}
    anns = [dict(a, image_id=image_of_pair[a["image_id"]], category_id=cat_of_pair[a["image_id"]])
            for a in gt["annotations"]]
    coco = dict(images=list(info.values()), annotations=anns,
                categories=[dict(id=k + 1, name=q) for k, q in enumerate(QUERIES)])
    path = os.path.join(root, "coco.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    return path


def write_video_fixture(root: str, frames: int = 6, size: int = 112, mask_side: int = 32,
                        seed: int = 0, text: str = "a red square") -> str:
    """A one-video dataset in eval_video's format under ``root``: a folder
    of ``frames`` PNG frames (two red squares drifting over noise) and each
    frame's ground truth, the squares' masks at ``mask_side`` (the video
    pipeline's output size), as npz files. Returns the dataset json's path."""
    import json

    import numpy as np

    rng = np.random.default_rng(seed)
    fdir = os.path.join(root, "frames")
    os.makedirs(fdir, exist_ok=True)
    starts = np.array([[0.2, 0.25], [0.55, 0.6]])
    half = 0.12
    anns = []
    for t in range(frames):
        img = rng.integers(60, 120, (size, size, 3), np.uint8)
        masks = np.zeros((len(starts), mask_side, mask_side), bool)
        for k, (cx, cy) in enumerate(starts + 0.02 * t):
            x0, x1 = int((cx - half) * size), int((cx + half) * size)
            y0, y1 = int((cy - half) * size), int((cy + half) * size)
            img[y0:y1, x0:x1] = (210, 40, 40)
            s = mask_side / size
            masks[k, int(y0 * s):int(y1 * s), int(x0 * s):int(x1 * s)] = True
        save_rgb(os.path.join(fdir, f"{t:05d}.png"), img)
        np.savez(os.path.join(root, f"gt_{t:03d}.npz"), masks=masks)
        anns.append({"obj_ids": list(range(1, len(starts) + 1)), "masks_npz": f"gt_{t:03d}.npz"})
    path = os.path.join(root, "videos.json")
    with open(path, "w") as f:
        json.dump({"videos": [{"id": 0, "frames_dir": "frames", "text": text,
                               "annotations": anns}]}, f)
    return path
