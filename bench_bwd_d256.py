#!/usr/bin/env python3
"""Time the bf16 flash-attention backward kernels at head dim 256 on one
NVIDIA GPU: flash_sdpa_bwd_dq and flash_sdpa_bwd_dkv at the tracker
training clip's cross-attention (q (8, 1, 5184, 256), k/v (8, 1, 36352,
256)) and self-attention (k/v 5184 keys) shapes, 3 of 8 object slots live,
dO a strided view, each in a CUDA graph (chip_smoke.graph_time).

    python3 bench_bwd_d256.py [--other DIR]

With --other, the same timings of the checkout at DIR (another commit's
kernels, built there) are taken in the same process order other, this,
this, other, each in its own process, so that two versions compare on one
card. Prints one line a run, with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys


def run_here():
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.ops import _build
    from efficientsam3_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd_d256: no CUDA device")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    scale = 256 ** -0.5
    parts = []
    for name, lk in (("cross", 36352), ("self", 5184)):
        q, k, v = randn(8, 1, 5184, 256), randn(8, 1, lk, 256), randn(8, 1, lk, 256)
        bias = torch.full((8, lk), fa.NEG_INF, device="cuda")
        bias[:3] = 0.0
        bias[:3, -37:] = fa.NEG_INF
        o, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
        do = randn(8, 5184, 256).reshape(8, 5184, 1, 256).transpose(1, 2)
        _, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
        per, reps = (2, 5) if name == "cross" else (5, 10)
        ms_dq = cs.graph_time(lambda: fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale),
                              per, reps)
        ms_dkv = cs.graph_time(lambda: fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale),
                               per, reps)
        parts.append(f"{name} dq {ms_dq:.4f} ms dkv {ms_dkv:.4f} ms")
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    print(f"[bench_bwd_d256] {os.getcwd()}: {' | '.join(parts)} (CUDA graph) | "
          f"{cs.nvidia_smi_line()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of another checkout to time in turns with this one")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.here or not args.other:
        run_here()
        return
    me = os.path.abspath(__file__)
    here = os.path.dirname(me)
    for root in (args.other, here, here, args.other):
        subprocess.run([sys.executable, me, "--here"], cwd=root, check=True, timeout=600)


if __name__ == "__main__":
    main()
