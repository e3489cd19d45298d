"""Sam3Processor: the user-facing stateful inference API of the port.

Counterpart of efficientsam3_tpu/processor.py: set_image / set_image_batch /
set_text_prompt / add_geometric_prompt / add_point_prompt /
reset_all_prompts, with the same preprocessing (antialiased linear resize
to resolution x resolution as jax.image.resize computes it, then mean/std
0.5) and postprocessing (sigmoid(logits) x sigmoid(presence) > threshold,
boxes rescaled to the original size, bilinear mask upsampling, 0.5
binarisation). Image and text features stay on the model's device between
calls; adding a prompt re-runs only ``ground``. Results come back as numpy
arrays, as from the JAX processor.

The tokenizer is built the first time a string prompt needs it (the CLIP
BPE vocab is not in the repository). A caller may put encoded text,
``model.encode_text(tokens)``, into ``state["text"]`` and drive geometric
prompts without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from efficientsam3_tpu_torch.models.decoder import box_cxcywh_to_xyxy
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased, resize_bilinear

MEAN = 0.5
STD = 0.5


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class Sam3Processor:
    def __init__(self, model, resolution: int = 1008, confidence_threshold: float = 0.5,
                 bpe_path: Optional[str] = None, max_boxes: int = 8, max_points: int = 8,
                 context_length: Optional[int] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.resolution = resolution
        self.confidence_threshold = confidence_threshold
        self.max_boxes = max_boxes
        self.max_points = max_points
        self.context_length = context_length or model.text_context_length
        self.bpe_path = bpe_path
        self._tokenizer = None

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from efficientsam3_tpu_torch.utils.tokenizer import ClipTokenizer

            self._tokenizer = ClipTokenizer(self.bpe_path)
        return self._tokenizer

    # ------------------------------------------------------------------

    def preprocess(self, image: np.ndarray) -> torch.Tensor:
        """HWC uint8/float -> (1, R, R, 3) normalized fp32 on the model's device."""
        img = torch.as_tensor(np.asarray(image), device=self.device)
        img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
        img = resize_antialiased(img, (self.resolution, self.resolution))
        return ((img - MEAN) / STD)[None]

    @torch.inference_mode()
    def set_image(self, image: np.ndarray, state: Optional[dict] = None) -> dict:
        state = state if state is not None else {}
        state["original_height"], state["original_width"] = image.shape[:2]
        state["image_feats"] = self.model.encode_image(self.preprocess(image))
        return state

    @torch.inference_mode()
    def set_image_batch(self, images, state: Optional[dict] = None) -> dict:
        """Batched variant: one encode over the stacked batch; grounding then
        runs per image and returns per-image lists."""
        state = state if state is not None else {}
        state["original_heights"] = [im.shape[0] for im in images]
        state["original_widths"] = [im.shape[1] for im in images]
        batch = torch.cat([self.preprocess(im) for im in images], dim=0)
        state["image_feats"] = self.model.encode_image(batch)
        state["batch_size"] = len(images)
        return state

    def _empty_prompt(self):
        return Prompt.empty(1, self.max_boxes, self.max_points, device=self.device)

    @torch.inference_mode()
    def encode_tokens(self, tokens) -> tuple:
        """(B, L) int token ids -> the model's (text_memory, pad_mask)."""
        return self.model.encode_text(torch.as_tensor(np.asarray(tokens), device=self.device))

    def set_text_prompt(self, prompt: str, state: dict) -> dict:
        if "image_feats" not in state:
            raise ValueError("call set_image before set_text_prompt")
        state["text"] = self.encode_tokens(self.tokenizer([prompt], self.context_length))
        state.setdefault("geometric_prompt", self._empty_prompt())
        return self._forward_grounding(state)

    def _ensure_text(self, state: dict):
        if "text" not in state:
            # geometry-only mode uses the "visual" dummy text prompt
            state["text"] = self.encode_tokens(self.tokenizer(["visual"], self.context_length))
        state.setdefault("geometric_prompt", self._empty_prompt())
        state.setdefault("num_boxes", 0)
        state.setdefault("num_points", 0)

    def add_geometric_prompt(self, box, label: bool, state: dict) -> dict:
        """box: normalized [cx, cy, w, h]."""
        if "image_feats" not in state:
            raise ValueError("call set_image before add_geometric_prompt")
        self._ensure_text(state)
        slot = state["num_boxes"]
        if slot >= self.max_boxes:
            raise ValueError(f"too many box prompts (max {self.max_boxes})")
        state["geometric_prompt"] = state["geometric_prompt"].with_box(
            0, slot, np.asarray(box, np.float32), int(label))
        state["num_boxes"] = slot + 1
        return self._forward_grounding(state)

    def add_point_prompt(self, point, label: int, state: dict) -> dict:
        """point: [x, y] pixel coords in the ORIGINAL image."""
        if "image_feats" not in state:
            raise ValueError("call set_image before add_point_prompt")
        self._ensure_text(state)
        slot = state["num_points"]
        if slot >= self.max_points:
            raise ValueError(f"too many point prompts (max {self.max_points})")
        xy = np.asarray([point[0] / state["original_width"],
                         point[1] / state["original_height"]], np.float32)
        state["geometric_prompt"] = state["geometric_prompt"].with_point(0, slot, xy, int(label))
        state["num_points"] = slot + 1
        return self._forward_grounding(state)

    def reset_all_prompts(self, state: dict):
        for k in ("text", "geometric_prompt", "num_boxes", "num_points",
                  "boxes", "masks", "masks_logits", "scores"):
            state.pop(k, None)

    def set_confidence_threshold(self, threshold: float, state: Optional[dict] = None):
        self.confidence_threshold = threshold
        if state is not None and "boxes" in state:
            return self._forward_grounding(state)
        return state

    # ------------------------------------------------------------------

    def _postprocess(self, out, h: int, w: int):
        """ground's batch-1 outputs -> (scores, boxes, mask probs) at (h, w)."""
        logits = out["pred_logits"][0, :, 0].float().cpu().numpy()
        presence = _sigmoid(out["presence_logit_dec"].float().cpu().numpy())[0]
        probs = _sigmoid(logits) * float(presence)
        keep = probs > self.confidence_threshold
        keep_t = torch.as_tensor(keep, device=out["pred_masks"].device)
        boxes_c = out["pred_boxes"][0][keep_t].float()
        boxes = box_cxcywh_to_xyxy(boxes_c).cpu().numpy() * np.asarray([w, h, w, h], np.float32)
        masks_lo = out["pred_masks"][0][keep_t]
        if masks_lo.shape[0] > 0:
            masks_logits = resize_bilinear(masks_lo.float()[:, None], (h, w))[:, 0]
            masks_prob = torch.sigmoid(masks_logits).cpu().numpy()
        else:
            masks_prob = np.zeros((0, h, w), np.float32)
        return probs[keep], boxes, masks_prob

    @torch.inference_mode()
    def _forward_grounding(self, state: dict) -> dict:
        if "batch_size" in state:
            return self._forward_grounding_batch(state)
        feats = state["image_feats"]
        tm, tmask = state["text"]
        out = self.model.ground(feats["fpn"], feats["pos"], tm, tmask, state["geometric_prompt"])
        scores, boxes, masks_prob = self._postprocess(
            out, state["original_height"], state["original_width"])
        state["scores"] = scores
        state["boxes"] = boxes
        state["masks_logits"] = masks_prob
        state["masks"] = masks_prob > 0.5
        return state

    def _forward_grounding_batch(self, state: dict) -> dict:
        """Batched grounding: one ground per image of the encoded batch
        (each image has its own original size); per-image lists."""
        feats = state["image_feats"]
        tm, tmask = state["text"]
        prompt = state["geometric_prompt"]
        for key in ("scores", "boxes", "masks_logits", "masks"):
            state[key] = []
        for i in range(state["batch_size"]):
            fpn_i = [lvl[i:i + 1] for lvl in feats["fpn"]]
            out = self.model.ground(fpn_i, feats["pos"], tm, tmask, prompt)
            scores, boxes, masks_prob = self._postprocess(
                out, state["original_heights"][i], state["original_widths"][i])
            state["scores"].append(scores)
            state["boxes"].append(boxes)
            state["masks_logits"].append(masks_prob)
            state["masks"].append(masks_prob > 0.5)
        return state
