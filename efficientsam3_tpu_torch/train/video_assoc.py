"""Video training: a frame-pair dataset and the detection <-> tracking
association head.

Counterpart of efficientsam3_tpu/train/video_assoc.py. The reference
trains video grounding with a Det2TrkAssoc loss over association logits
between detection queries and tracking queries; the producing head is not
in the released tree, so, as in JAX:

  - AssocHead: scaled dot products between projected detection queries and
    [tracking queries; new_object; false_positive] slots ->
    (B, Q_det, Q_trk + 2) logits;
  - FramePairDataset: synthetic (frame_t, frame_t+1) pairs with persistent
    object ids, numpy only (the same seed gives the JAX package's batches);
  - assoc_train_step: one step of ``train.losses.det2trk_assoc_loss`` over
    the head. No kernel of the port's is on this path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from efficientsam3_tpu_torch.models.common import Dense
from efficientsam3_tpu_torch.train.losses import det2trk_assoc_loss


class AssocHead(nn.Module):
    """Association logits between detection and tracking queries of width
    d_model."""

    def __init__(self, d_model: int = 256):
        super().__init__()
        self.d_model = d_model
        self.det_proj = Dense(d_model, d_model)
        self.trk_proj = Dense(d_model, d_model)
        self.new_object_embed = nn.Parameter(torch.empty(1, 1, d_model))
        self.false_positive_embed = nn.Parameter(torch.empty(1, 1, d_model))

    def forward(self, det_queries, trk_queries):
        """det (B, Qd, C), trk (B, Qt, C) -> (B, Qd, Qt + 2)."""
        q = self.det_proj(det_queries)
        k = self.trk_proj(trk_queries)
        b, d = det_queries.shape[0], self.d_model
        extra = torch.cat([self.new_object_embed, self.false_positive_embed], dim=1)
        keys = torch.cat([k, extra.expand(b, 2, d).to(k.dtype)], dim=1)
        return torch.einsum("bqc,bkc->bqk", q, keys) / math.sqrt(d)


class FramePairDataset:
    """Synthetic (frame_t, frame_t+1) pairs with persistent object ids.

    Each sample carries per-frame detection-query features and the previous
    frame's tracking-query features, derived from per-object latent codes
    plus noise, with ids assigned the way the video matcher would
    (Hungarian on the real model; identity codes here keep the dataset
    model-free)."""

    def __init__(self, q_det=12, q_trk=6, d_model=32, num_objects=4,
                 noise: float = 0.3, seed: int = 0):
        self.q_det, self.q_trk, self.d = q_det, q_trk, d_model
        self.num_objects = num_objects
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.codes = self.rng.normal(0, 1, (64, d_model)).astype(np.float32)

    def batch(self, batch_size: int):
        b, qd, qt, d = batch_size, self.q_det, self.q_trk, self.d
        det = self.rng.normal(0, 1, (b, qd, d)).astype(np.float32)
        trk = self.rng.normal(0, 1, (b, qt, d)).astype(np.float32)
        ids = -np.ones((b, qd + qt), np.int64)
        for bi in range(b):
            n = int(self.rng.integers(1, self.num_objects + 1))
            obj_ids = self.rng.choice(64, n, replace=False)
            # each object appears as one tracking query (prev frame) and,
            # with high probability, one detection query (current frame)
            trk_slots = self.rng.choice(qt, min(n, qt), replace=False)
            det_slots = self.rng.choice(qd, min(n, qd), replace=False)
            for k, oid in enumerate(obj_ids):
                if k < len(trk_slots):
                    trk[bi, trk_slots[k]] = (
                        self.codes[oid]
                        + self.rng.normal(0, self.noise, d)
                    )
                    ids[bi, qd + trk_slots[k]] = oid
                if k < len(det_slots) and self.rng.random() < 0.9:
                    det[bi, det_slots[k]] = (
                        self.codes[oid]
                        + self.rng.normal(0, self.noise, d)
                    )
                    ids[bi, det_slots[k]] = oid
        return {
            "det_queries": det,
            "trk_queries": trk,
            "matched_object_ids": ids,
        }


def assoc_train_step(head: AssocHead, optimizer: torch.optim.Optimizer):
    """(batch) -> loss: one association step over ``head`` (in place).
    batch: ``FramePairDataset.batch``'s arrays, numpy or tensors (moved to
    the head's device); num_boxes is the count of matched detection
    queries, at least 1."""
    dev = head.det_proj.weight.device

    def step(batch):
        det, trk, ids = (torch.as_tensor(batch[k]).to(dev)
                         for k in ("det_queries", "trk_queries", "matched_object_ids"))
        logits = head(det, trk)
        num_boxes = (ids[:, :logits.shape[1]] >= 0).sum().float().clamp_min(1.0)
        loss = det2trk_assoc_loss(logits, ids, num_boxes)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
