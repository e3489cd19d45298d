"""EfficientSam3System: one handle over the detector and the tracker.

Counterpart of efficientsam3_tpu/system.py, with modules in place of
(module, variables) pairs: a single object exposing

  .processor()             text/box/point image PCS  (Sam3Processor)
  .interactive_predictor() SAM1-task point/box masks (InteractiveImagePredictor)
  .tracker_predictor()     VOS streaming tracker     (TrackerPredictor)
  .video_predictor()       full video PCS: detect + track (VideoPCSPredictor)
  .server()                session-based serving facade (VideoPredictorServer)

all over one image model and one tracker core (build them with
``build.build_efficientsam3_video_model``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class EfficientSam3System:
    def __init__(self, image_model, tracker_core=None, context_length: Optional[int] = None,
                 bpe_path: Optional[str] = None):
        self.image_model = image_model
        self.tracker_core = tracker_core
        self.context_length = context_length or image_model.text_context_length
        self.bpe_path = bpe_path

    @torch.inference_mode()
    def encode_frame(self, img):
        """(1, H, W, 3) normalized -> dict with 'sam2_fpn' for the tracker."""
        out = self.image_model.encode_image(img)
        if "sam2_fpn" not in out:
            raise ValueError("model built without the SAM2 neck; build it with "
                             "enable_inst_interactivity=True")
        return out

    def processor(self, **kwargs):
        from efficientsam3_tpu_torch.processor import Sam3Processor

        return Sam3Processor(self.image_model, context_length=self.context_length,
                             bpe_path=self.bpe_path, **kwargs)

    def interactive_predictor(self, **kwargs):
        from efficientsam3_tpu_torch.sam1_task import InteractiveImagePredictor

        self._require_tracker()
        return InteractiveImagePredictor(self.tracker_core, self.encode_frame, **kwargs)

    def tracker_predictor(self, **kwargs):
        from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

        self._require_tracker()
        return TrackerPredictor(self.tracker_core, self.encode_frame, **kwargs)

    def video_predictor(self, pcs_config=None, **kwargs):
        """Video PCS over this system's detector and tracker. text_state is a
        processor state holding the encoded prompt ("text", and optionally
        "geometric_prompt"). As in the JAX package the detector encodes each
        frame itself (``set_image``), beside the tracker's ``encode_frame``
        of the same frame: two trunk passes a frame."""
        from efficientsam3_tpu_torch.video.pipeline import VideoPCSPredictor

        proc = self.processor()

        def detector(frame, text_state):
            state = dict(text_state or {})
            state = proc.set_image(np.asarray(frame), state)
            proc._ensure_text(state)  # the "visual" text only when none was given
            state = proc._forward_grounding(state)
            return {"masks": np.asarray(state["masks"]), "scores": np.asarray(state["scores"]),
                    "boxes": np.asarray(state["boxes"])}

        return VideoPCSPredictor(detector, self.tracker_predictor(**kwargs), pcs_config)

    def server(self, **kwargs):
        from efficientsam3_tpu_torch.video.server import VideoPredictorServer

        return VideoPredictorServer(self.tracker_predictor(**kwargs))

    def _require_tracker(self):
        if self.tracker_core is None:
            raise ValueError("system built without a tracker core")
