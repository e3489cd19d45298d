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

With --clip it times the tracker's bf16 training clip instead, as
chip_smoke.py's [tracker_train] phase composes it (chip_smoke.tracker_clip:
8 frames, 8 object slots of which 3 prompted, the features of seeded
frames precomputed): forward and backward between CUDA events, the
dropout bits seeded, median of 5 after 1 warm-up. Each line (step or
clip) also gives the device time of one more under torch.profiler.

With --cudnn-deterministic the step or the clip is timed with
torch.backends.cudnn.deterministic off, on, on and off in each process,
each block a median of its own.

    python3 bench_tracked_frame.py [--other DIR] [--stage3 | --clip] [--cudnn-deterministic]

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


def det_modes(flag):
    """cudnn.deterministic settings to time, in order: off, on, on, off
    with the flag, else the setting as it stands."""
    import torch

    return (False, True, True, False) if flag else (torch.backends.cudnn.deterministic,)


def device_ms(fn):
    """The device time of one fn() under torch.profiler: the kernels' self
    time summed, ms (0 where the profiler recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def measure_step(label, det=False):
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
    for mode in det_modes(det):
        torch.backends.cudnn.deterministic = mode
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
        dev_ms = device_ms(lambda: stage3.stage3_train_step(model, opt, batch))
        print(f"[{label}] bf16 Stage-3 step (EV-M 1008^2, batch {cs.TRAIN_BATCH}, "
              f"cudnn.deterministic {mode}): {statistics.median(ms):.3f} ms (median of "
              f"{len(ms)}; min {min(ms):.3f}), device time of one more step {dev_ms:.3f} ms | "
              f"flash_sdpa_bwd_dq {launches[-1][0]}, flash_sdpa_bwd_dkv {launches[-1][1]} "
              f"launches a step | loss {loss:.6g} | {smi}", flush=True)


def measure_clip(label, det=False):
    import statistics

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d

    if not torch.cuda.is_available():
        raise SystemExit("bench_tracked_frame: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    # chip_smoke.py [tracker_train]'s configuration: the fuser's layer scales
    # at 1, the object-score bias raised by 10, training mode
    image, core = build_efficientsam3_video_model(model_name="b1", dtype=torch.bfloat16,
                                                  device=dev, seed=0)
    with torch.no_grad():
        for blk in core.memory_encoder.fuser:
            blk.gamma.fill_(1.0)
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    core.train().requires_grad_(True)
    fs, d = core.feat_size, core.d_model
    frames = np.random.default_rng(7).standard_normal(
        (cs.TT_FRAMES, 1008, 1008, 3)).astype(np.float32)
    feats = []
    with torch.no_grad():
        for t in range(cs.TT_FRAMES):
            fpn = image.encode_image(torch.as_tensor(frames[t], device=dev)[None])["sam2_fpn"]
            feats.append((fpn[2].reshape(1, fs * fs, d), fpn[0], fpn[1]))
    del image, fpn
    pos = sine_pos_embed_2d(fs, fs, d, device=dev).reshape(fs * fs, d)
    gen = torch.Generator(device=dev).manual_seed(5)
    proj = torch.randn((cs.TT_FRAMES, cs.TT_SLOTS, 1, 4 * fs, 4 * fs), generator=gen,
                       device=dev)
    def clip():
        torch.manual_seed(0)
        core.zero_grad(set_to_none=True)
        loss, _ = cs.tracker_clip(core, feats, pos, proj, cs.TT_LIVE)
        loss.backward()
        return loss.detach()

    for mode in det_modes(det):
        torch.backends.cudnn.deterministic = mode
        fwd, bwd = [], []
        for i in range(6):
            torch.manual_seed(0)
            core.zero_grad(set_to_none=True)
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            loss, _ = cs.tracker_clip(core, feats, pos, proj, cs.TT_LIVE)
            e[1].record()
            loss.backward()
            e[2].record()
            e[2].synchronize()
            loss = loss.detach()
            if i >= 1:
                fwd.append(e[0].elapsed_time(e[1]))
                bwd.append(e[1].elapsed_time(e[2]))
        if not torch.isfinite(loss):
            raise AssertionError(f"non-finite loss {float(loss)}")
        total = [a + b for a, b in zip(fwd, bwd)]
        dev_ms = device_ms(clip)
        print(f"[{label}] bf16 tracker training clip ({cs.TT_FRAMES} frames, {cs.TT_SLOTS} "
              f"slots, {cs.TT_LIVE} live, cudnn.deterministic {mode}): "
              f"{statistics.median(total):.3f} ms (median of {len(total)}; min {min(total):.3f}): "
              f"forward {statistics.median(fwd):.3f}, backward {statistics.median(bwd):.3f}, "
              f"device time of one more clip {dev_ms:.3f} ms | loss {float(loss):.6g} | {smi}",
              flush=True)


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
    ap.add_argument("--clip", action="store_true",
                    help="time the tracker's bf16 training clip instead of a tracked frame")
    ap.add_argument("--cudnn-deterministic", action="store_true",
                    help="time the step or the clip with cudnn.deterministic off and on")
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.other is None or args.label is not None:
        label = args.label or "this"
        if args.stage3:
            measure_step(label, args.cudnn_deterministic)
        elif args.clip:
            measure_clip(label, args.cudnn_deterministic)
        else:
            measure(label)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    flags = [f for f, on in (("--stage3", args.stage3), ("--clip", args.clip),
                             ("--cudnn-deterministic", args.cudnn_deterministic)) if on]
    for where, label in ((other, "other"), (here, "this"), (here, "this"), (other, "other")):
        subprocess.run([sys.executable, os.path.join(here, "bench_tracked_frame.py"), "--label",
                        f"{label} ({os.path.relpath(where, here)})", *flags], cwd=where,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
