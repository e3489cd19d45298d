"""Port of efficientsam3_tpu/eval/distributed.py onto torch.distributed.

Distributed evaluation helpers (reference P4, SURVEY §2.10). The reference
shards eval datasets with torchrun and all_gathers prediction payloads over
NCCL with CPU/filesystem fallbacks (train/utils/distributed.py:57-186).
Here a process takes its rank and world size from the default process
group when one is initialised (0 and 1 without one), shards by rank,
gathers small arrays with ``dist.all_gather`` on the group's device (the
card under NCCL, the CPU under gloo), and gathers large prediction
payloads through the same filesystem rendezvous trick.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _rank_and_size() -> tuple:
    """(rank, world size) in the default process group, or (0, 1) when none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_process(items: Sequence, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> list:
    """Round-robin shard of eval items for this process."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def all_gather_array(x: np.ndarray) -> np.ndarray:
    """Gather a small per-process array (of one shape on every rank)
    across the default group: the ranks' arrays stacked on a new axis 0, or
    ``x`` itself in a world of one."""
    _, size = _rank_and_size()
    if size == 1:
        return x
    if dist.get_backend() == dist.Backend.NCCL:
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    t = torch.from_numpy(np.asarray(x, order="C")).to(device)  # 0-d stays 0-d
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def all_gather_via_filesys(obj, rendezvous_dir: str, tag: str = "preds",
                           timeout_s: float = 600.0,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> list:
    """Filesystem gather for huge eval payloads (reference
    train/utils/distributed.py:57 all_gather_via_filesys)."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    os.makedirs(rendezvous_dir, exist_ok=True)
    mine = os.path.join(rendezvous_dir, f"{tag}_{pi}.pkl")
    tmp = mine + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, mine)
    out = []
    deadline = time.time() + timeout_s
    for r in range(pc):
        path = os.path.join(rendezvous_dir, f"{tag}_{r}.pkl")
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"rank {r} payload missing: {path}")
            time.sleep(0.5)
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def write_coco_predictions(path: str, predictions: list):
    """COCO-format prediction file writer (reference eval/coco_writer.py)."""
    with open(path, "w") as f:
        json.dump(predictions, f)
