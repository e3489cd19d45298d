"""Interactive VOS example: click an object on frame 0, track it.

Counterpart of examples/video_tracking_example.py of the JAX package (the
reference's sam3 dense video tracking / tracker notebooks) over a frame
folder (DAVIS / MOSE layout): ``TrackerPredictor`` from
``EfficientSam3System.tracker_predictor``. Without a folder, 4 random
frames. Frames go to the tracker at the model's resolution, normalised
(mean / std 0.5). Seeded weights; a reference checkpoint would load through
``load_reference_checkpoint(core, path, part="tracker")``.

    python -m efficientsam3_tpu_torch.examples.video_tracking_example [frames_dir]
"""

from __future__ import annotations

import argparse

import numpy as np

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, model_resolution
from efficientsam3_tpu_torch.system import EfficientSam3System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir", nargs="?", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    image_model, tracker_core = build_efficientsam3_video_model(
        backbone_type="efficientvit", model_name="m",
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        device=resolve_device(args.device),
    )
    res = model_resolution(image_model)

    if args.frames_dir:
        from efficientsam3_tpu_torch.video.io import load_video_frames

        frames = load_video_frames(args.frames_dir, resolution=res)
    else:
        frames = (np.random.default_rng(0).random((4, res, res, 3)) * 255).astype(np.uint8)

    tracker = EfficientSam3System(image_model, tracker_core).tracker_predictor()
    state = tracker.init_state((frames.astype(np.float32) / 255.0 - 0.5) / 0.5)
    tracker.add_new_points_or_box(
        state, 0, obj_id=1, points=[[res // 2, res // 2]], labels=[1]
    )
    out = []
    for frame_idx, obj_ids, masks in tracker.propagate_in_video(state):
        areas = [int((m > 0).sum()) for m in masks]
        print(f"frame {frame_idx}: objects {list(obj_ids)} mask areas {areas}")
        out.append((frame_idx, list(obj_ids), areas))
    return out


if __name__ == "__main__":
    main()
