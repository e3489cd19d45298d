#!/usr/bin/env python3
"""Time one tracked frame of the video tracker at full width on one NVIDIA
GPU, in bf16 and in the default fp32 build, on the exact and on the int8
key bank: EV-M (EfficientViT-b1 with the SAM2 neck) and TrackerCore at
1008^2, seed 0, 8 object slots, 3 objects prompted on frame 0 (a box, a
click, a click pair), 12 synthetic frames propagated on the cached bank
(the default; with quantize_bank=True its keys int8), then the last frame
tracked again (its memory in place: every slot's 7 bank entries as a
12-frame session leaves them) and timed between CUDA events (median of 10
after 2 warm-ups). The mask decoder's object-score bias is raised by 10
so that seeded weights keep their objects (as chip_smoke.py's [fp32] and
[pcs] phases do). Per tracked frame the bank attention (flash_memattn, or
flash_memattn_q8 on the int8 bank) and the d=256 self-attention
(flash_sdpa) launch 4 times each; the line gives their launches and the
sum of the objects' low-resolution mask logits.

With --stage3 it times one bf16 Stage-3 training step instead, as
chip_smoke.py's [train] phase takes it: EV-M at 1008^2, batch 4 of
chip_smoke.stage3_batch, stage3_train_step between CUDA events (median of
8 after 2 warm-up steps); per step the fusion encoder's attention launches
its forward, dq and dkv kernels 6 times each.

    python3 bench_tracked_frame.py [--other DIR] [--stage3]

With --other, the checkout at DIR (another commit, built there) is timed in
the process order other, this, this, other, each in its own process, so
that two versions compare on one card. Prints one line a dtype, bank and
run (or a step and run), with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys

N_FRAMES = 12


def measure_step(label):
    import statistics

    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.train import stage3

    if not torch.cuda.is_available():
        raise SystemExit("bench_tracked_frame: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0)
    opt = stage3.make_stage3_optimizer(stage3.Stage3Config(), model)
    batch = cs.stage3_batch(cs.TRAIN_BATCH, 32, dev)
    ms, launches = [], []
    for i in range(10):
        n = (fa.flash_sdpa_bwd_dq.launches, fa.flash_sdpa_bwd_dkv.launches)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        metrics = stage3.stage3_train_step(model, opt, batch)
        t1.record()
        torch.cuda.synchronize()
        if i >= 2:
            ms.append(t0.elapsed_time(t1))
            launches.append((fa.flash_sdpa_bwd_dq.launches - n[0],
                             fa.flash_sdpa_bwd_dkv.launches - n[1]))
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"[{label}] bf16 Stage-3 step (EV-M 1008^2, batch {cs.TRAIN_BATCH}): "
          f"{statistics.median(ms):.3f} ms (median of {len(ms)}; min {min(ms):.3f}) | "
          f"flash_sdpa_bwd_dq {launches[-1][0]}, flash_sdpa_bwd_dkv {launches[-1][1]} launches "
          f"a step | loss {loss:.6g} | {smi}", flush=True)


def measure(label):
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

    if not torch.cuda.is_available():
        raise SystemExit("bench_tracked_frame: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    frames = np.random.default_rng(7).standard_normal(
        (N_FRAMES, 1008, 1008, 3)).astype(np.float32)
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        image, core = build_efficientsam3_video_model(model_name="b1", dtype=dtype, device=dev,
                                                      seed=0)
        with torch.no_grad():
            core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
        for quantize in (False, True):
            bank = "flash_memattn_q8" if quantize else "flash_memattn"
            pred = TrackerPredictor(core, image.encode_image, obj_slots=8,
                                    quantize_bank=quantize)
            state = pred.init_state(frames)
            for obj_id, kw in ((1, dict(box=[100, 150, 400, 520])),
                               (2, dict(points=[[700, 300]], labels=[1])),
                               (3, dict(points=[[500, 800], [560, 760]], labels=[1, 0]))):
                pred.add_new_points_or_box(state, 0, obj_id, **kw)
            for _ in pred.propagate_in_video(state):
                pass
            if "kv_bank" not in state:
                raise AssertionError("the session did not build the cached bank")

            def frame():
                with torch.inference_mode():
                    return pred._run_track_frame(state, N_FRAMES - 1)

            frame()
            torch.cuda.synchronize()
            before = (getattr(fa, bank).launches, fa.flash_sdpa.launches)
            out = frame()
            torch.cuda.synchronize()
            launches = (getattr(fa, bank).launches - before[0],
                        fa.flash_sdpa.launches - before[1])
            masks = out["low_res_masks"][:3].float()  # the 3 objects' slots
            if not torch.isfinite(masks).all():
                raise AssertionError(f"{name}: non-finite masks")
            ms = cs.cuda_time(frame, 10, warmup=2)
            print(f"[{label}] {name} tracked frame ({'int8' if quantize else 'cached'} bank, 3 "
                  f"of 8 slots, {N_FRAMES - 1} tracked before): {ms:.3f} ms | {bank} "
                  f"{launches[0]}, flash_sdpa {launches[1]} launches | mask logits sum "
                  f"{float(masks.sum()):.6g} | {smi}", flush=True)
            del pred, state
            torch.cuda.empty_cache()
        del image, core
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout, timed in turns with this one")
    ap.add_argument("--stage3", action="store_true",
                    help="time a bf16 Stage-3 training step instead of a tracked frame")
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.other is None or args.label is not None:
        (measure_step if args.stage3 else measure)(args.label or "this")
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    for where, label in ((other, "other"), (here, "this"), (here, "this"), (other, "other")):
        subprocess.run([sys.executable, os.path.join(here, "bench_tracked_frame.py"), "--label",
                        f"{label} ({os.path.relpath(where, here)})",
                        *(("--stage3",) if args.stage3 else ())], cwd=where, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
