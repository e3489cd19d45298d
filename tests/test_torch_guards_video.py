"""No-JAX guard of the port's video PCS path (split from
tests/test_torch_guards.py): the system handle, the pipeline over the
real detector and the session server, in a fresh interpreter."""

import _torch_threads  # noqa: F401
from _torch_guard import run_without_jax

_PCS = r"""
import sys
import numpy as np
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.system import EfficientSam3System
from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig

image, core = build_efficientsam3_video_model(
    model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu")
system = EfficientSam3System(image, core)
proc = system.processor()
tokens = np.zeros((1, 16), np.int64)
tokens[0, :3] = [49406, 320, 49407]
pipe = system.video_predictor(VideoPCSConfig(obj_slots=2, hotstart_delay=2), obj_slots=2,
                              max_point_prompts=4, quantize_bank=True)
frames = np.zeros((3, 112, 112, 3), np.float32)
outs = list(pipe.run_video(frames, {"text": proc.encode_tokens(tokens)}))
assert [o["frame_idx"] for o in outs] == [0, 1, 2], outs
server = system.server(obj_slots=2, max_point_prompts=4, fill_hole_area=8)
sid = server.start_session(frames)
server.add_points(sid, 0, 1, points=[[40, 50]], labels=[1])
assert [r["masks"].shape for r in server.propagate_in_video(sid)] == [(1, 1, 32, 32)] * 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""



def test_video_pcs_runs_without_jax():
    """So do the system handle, the video PCS pipeline over the real
    detector (int8 bank) and the session server (hole filling on)."""
    run_without_jax(_PCS)
