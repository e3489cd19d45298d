"""SAM1-task interactive predictor: single-image point/box segmentation via
the tracker's SAM heads (no memory).

Counterpart of efficientsam3_tpu/sam1_task.py: SAM2-neck features +
no_mem_embed -> prompt encoder + mask decoder; boxes become two corner
points labelled 2/3. The image is resized as the JAX predictor resizes it
(antialiased linear, then mean/std 0.5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased, resize_bilinear
from efficientsam3_tpu_torch.video.tracker import TrackerCore


class InteractiveImagePredictor:
    """core: the TrackerCore whose heads predict; encode_frame: (1, H, W, 3)
    normalized -> {'sam2_fpn': [s0_raw, s1_raw, top]} (the image model's
    ``encode_image``)."""

    def __init__(self, core: TrackerCore, encode_frame, max_points: int = 8):
        self.core = core
        self.encode_frame = encode_frame
        self.max_points = max_points
        self.device = next(core.parameters()).device
        self._state = None

    @property
    def input_size(self):
        return self.core.image_size

    @torch.inference_mode()
    def set_image(self, image: np.ndarray):
        """image: (H, W, 3) uint8/float. Resizes to the model resolution."""
        h, w = image.shape[:2]
        img = torch.as_tensor(np.asarray(image), device=self.device)
        img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
        r = self.input_size
        img = ((resize_antialiased(img, (r, r)) - 0.5) / 0.5)[None]
        fpn = self.encode_frame(img)["sam2_fpn"]
        s0, s1 = self.core.sam_mask_decoder.high_res_convs(fpn[0], fpn[1])
        fs = self.core.feat_size
        tokens = fpn[2].reshape(1, fs * fs, self.core.d_model)
        self._state = {"tokens": tokens, "s0": s0, "s1": s1, "orig_hw": (h, w)}

    def _heads(self, tokens, s0, s1, coords, labels, multimask):
        core = self.core
        fs = core.feat_size
        pix = core.no_mem_features(tokens).reshape(tokens.shape[0], fs, fs, core.d_model)
        return core.forward_sam_heads(pix, coords, labels, (s0, s1), multimask)

    @torch.inference_mode()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                multimask_output: bool = True):
        """point_coords (P, 2) and box (4,) xyxy in original pixels. Returns
        (masks (M, H, W) bool, iou_predictions (M,), low_res (M, 288, 288))."""
        if self._state is None:
            raise ValueError("call set_image first")
        h, w = self._state["orig_hw"]
        r = self.input_size
        sx, sy = r / w, r / h
        # the token count matches the reference exactly: n prompts + ONE pad
        # point (the prompt encoder always appends one when boxes are absent,
        # and the two-way transformer attends to it)
        n_total = (2 if box is not None else 0) + (
            len(point_coords) if point_coords is not None else 0)
        width = n_total + 1
        pts = np.zeros((1, width, 2), np.float32)
        labs = -np.ones((1, width), np.int64)
        n = 0
        if box is not None:
            b = np.asarray(box, np.float32)
            pts[0, 0] = [b[0] * sx, b[1] * sy]
            pts[0, 1] = [b[2] * sx, b[3] * sy]
            labs[0, 0], labs[0, 1] = 2, 3
            n = 2
        if point_coords is not None:
            p = np.asarray(point_coords, np.float32) * np.asarray([sx, sy], np.float32)
            pts[0, n:n + len(p)] = p
            labs[0, n:n + len(p)] = np.asarray(point_labels, np.int64)
        st = self._state
        heads = self._heads(st["tokens"], st["s0"], st["s1"],
                            torch.as_tensor(pts, device=self.device),
                            torch.as_tensor(labs, device=self.device), multimask_output)
        low = heads["low_res_multimasks"] if multimask_output else heads["low_res_masks"]
        masks = resize_bilinear(low.float(), (h, w))[0].cpu().numpy()
        return masks > 0, heads["ious"][0].float().cpu().numpy(), low[0].float().cpu().numpy()

    @torch.inference_mode()
    def predict_batch(self, point_coords, stability_offset: float = 1.0):
        """Batched single-point prompting against the cached image embedding.

        point_coords: (P, 2) MODEL-resolution pixels. Returns tensors on the
        predictor's device (fetch only what survives filtering):
          low       (P*3, hl, wl) f32 low-res mask logits
          iou       (P*3,) predicted IoUs
          stability (P*3,) stability scores
          boxes     (P*3, 4) xyxy in low-res pixel coords
          empty     (P*3,) True where the thresholded mask is empty
        """
        if self._state is None:
            raise ValueError("call set_image first")
        st = self._state
        coords = torch.as_tensor(np.asarray(point_coords, np.float32), device=self.device)
        n_pts = coords.shape[0]
        # one prompt point + the single pad slot (see predict())
        pts = torch.cat([coords[:, None, :], torch.zeros((n_pts, 1, 2), device=self.device)], 1)
        labs = torch.tensor([[1, -1]], dtype=torch.long, device=self.device).expand(n_pts, 2)
        heads = self._heads(*(st[k].expand(n_pts, *st[k].shape[1:]) for k in ("tokens", "s0", "s1")),
                            pts, labs, True)
        low = heads["low_res_multimasks"]
        p, k, hl, wl = low.shape
        flat = low.reshape(p * k, hl, wl).float()
        iou = heads["ious"].reshape(p * k)
        hi = (flat > stability_offset).sum((-1, -2)).float()
        lo = (flat > -stability_offset).sum((-1, -2)).float()
        stability = hi / lo.clamp_min(1.0)
        fg = flat > 0
        any_x, any_y = fg.any(dim=1), fg.any(dim=2)
        xs = torch.arange(wl, device=self.device)
        ys = torch.arange(hl, device=self.device)
        big = 1 << 20
        x0 = torch.where(any_x, xs, big).amin(1)
        x1 = torch.where(any_x, xs, -1).amax(1) + 1
        y0 = torch.where(any_y, ys, big).amin(1)
        y1 = torch.where(any_y, ys, -1).amax(1) + 1
        empty = ~fg.any(dim=2).any(dim=1)
        boxes = torch.stack([x0, y0, x1, y1], dim=-1)
        boxes = torch.where(empty[:, None], 0, boxes).float()
        return flat, iou, stability, boxes, empty
