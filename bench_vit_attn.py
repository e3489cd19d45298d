#!/usr/bin/env python3
"""Time attention kernels on one NVIDIA GPU at full width. The flash_sdpa
forward: in bf16 at d=80 (vit_h at 1120^2: q/k/v (1, 16, 4900, 80)) and
at d=256 (the tracker's memory attention, 8 object slots of which 3 are
live: the self-attention q/k/v (8, 1, 5184, 256) and the plain path's
cross-attention over k/v (8, 1, 36352, 256), each live slot's last 37
keys masked); in fp32 at d=32 (the default build's `ground`, (1, 8, 5184,
32), and Stage-3 step, (4, 8, 5184, 32)), d=64 (the teacher's (1, 16,
5184, 64)), d=80 ((1, 16, 4900, 80)) and d=256 (the tracker's self and
cross shapes above). The tracker's bank attention (flash_memattn): q (8,
1, 5184, 256) over the padded 36864-key bank, k (8, 1, 36864, 256) and
raw values v (8, 1, 36864, 64) as the tracker hands them in (views of
(B, S, C) banks), N of 8 slots live with E of 7 entries of 5184 keys
valid: bf16 at 1, 3 and 8 slots with every entry (whether a slot's bank
stays in the L2 as more slots stream theirs), fp32 at 3 slots with 1 and
with 7 entries. The same bank over int8 keys (flash_memattn_q8: the
tracker's quantize_bank, k quantized per row by quantize_rows) at the same
slots and entries, each line with the exact bank's time over the
dequantized keys beside it. The backward's dq and dkv
kernels: in bf16 at d=32 (the Stage-3 step: (4, 8, 5184, 32)), d=64 (the
SAM3 teacher's ViT-H Stage-1 step at batch
2: (2, 16, 5184, 64)) and d=80; in fp32 at d=32 (the Stage-3 step), d=64
(an fp32 ViT-H Stage-1 step at batch 1: (1, 16, 5184, 64)) and d=80
(vit_h's). q, k and v are strided views of one packed qkv tensor (at
d=256 separate tensors, as the tracker hands them in) and dO a strided
view of a (B, N, H * D) gradient; every key of a live slot is live unless
stated. Each kernel is held against its plain version first (the
forward's output within 2e-2 (bf16) or 1e-4 (fp32) of its largest
magnitude and its LSE within 1e-2 or 1e-4; dQ, dK and dV within 2e-2 or
1e-4 of each one's largest magnitude, Delta within 1e-4, and dQ, dK and
dV the same bits when run again; a forward that misses is reported with
its error, not timed, and fails the run), then timed in a CUDA graph
(chip_smoke.graph_time) beside one F.scaled_dot_product_attention call
(forward, with the bool key mask where keys are masked; fp32 with TF32
off) and its backward (all three gradients). A forward line also gives
the call's time from the host between CUDA events, its profiler device
time (every kernel of the call: the fp32 wgmma forward's two split passes
with it), the plain version's time and the bound (chip_smoke.bound).

    python3 bench_vit_attn.py [--other DIR] [--dtype bf16|fp32] [--tracker | --q8]

With --other, the same measurement of the checkout at DIR (another commit's
kernels, or a variant copy, built there) is taken in the process order
other, this, this, other, each in its own process, so that two versions
compare on one card. --dtype keeps the shapes of one dtype, --tracker the
tracker's (the d=256 forwards and the bank), --q8 the int8 bank's and the
bf16 d=32 backward pair's. Prints one line a kernel and run, with the
card's name and power limit.
"""

import argparse
import os
import subprocess
import sys

# (B, H, Lq, Lk, D, dtype, live slots or None for every batch row)
FWD = ((1, 16, 4900, 4900, 80, "bf16", None), (8, 1, 5184, 5184, 256, "bf16", 3),
       (8, 1, 5184, 36352, 256, "bf16", 3), (1, 8, 5184, 5184, 32, "fp32", None),
       (4, 8, 5184, 5184, 32, "fp32", None), (1, 16, 5184, 5184, 64, "fp32", None),
       (1, 16, 4900, 4900, 80, "fp32", None))
FWD += ((8, 1, 5184, 5184, 256, "fp32", 3), (8, 1, 5184, 36352, 256, "fp32", 3))
# the bank: (live slots, valid entries, dtype)
MEM = ((1, 7, "bf16"), (3, 7, "bf16"), (8, 7, "bf16"), (3, 1, "fp32"), (3, 7, "fp32"))
BWD = ((4, 8, 5184, 32, "bf16"), (2, 16, 5184, 64, "bf16"), (1, 16, 4900, 80, "bf16"), (4, 8, 5184, 32, "fp32"),
       (1, 16, 5184, 64, "fp32"), (1, 16, 4900, 80, "fp32"))


def measure(label, only=None, tracker=False, q8=False):
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_vit_attn: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    smi = cs.nvidia_smi_line()
    failed = []

    def held(what, got, want, lse, want_lse, tol, lse_tol):
        """The max abs error of the output (held to tol of want's largest
        magnitude) and of the LSE (atol = rtol = lse_tol), or None after
        reporting a kernel that misses."""
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if err <= tol * scale and torch.allclose(lse, want_lse, atol=lse_tol, rtol=lse_tol):
            return max(err, lse_err)
        print(f"[{label}] {what}: DISAGREES with its plain version (max abs err {err:.3e}, "
              f"{err / max(scale, 1e-30):.3e} of the largest magnitude against {tol}; lse max "
              f"abs err {lse_err:.3e}): not timed | {smi}", flush=True)
        failed.append(what)
        return None

    def packed(b, h, n, d, dtype=bf16):
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device=dev).to(dtype)
        return qkv.permute(2, 0, 3, 1, 4)

    for b, h, lq, lk, d, dt, slots in FWD:
        if only not in (None, dt) or (tracker and d != 256) or q8:
            continue
        dtype = bf16 if dt == "bf16" else torch.float32
        if d == 256:
            q = torch.randn((b, h, lq, d), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((b, h, lk, d), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
        else:
            q, k, v = packed(b, h, lq, d, dtype)
        bias = torch.zeros((b, lk), device=dev)
        if slots is not None:
            bias[slots:] = fa.NEG_INF
            if lk != lq:
                bias[:, lk - 37:] = fa.NEG_INF
        live = int((bias > fa.NEG_INF / 2).sum().item()) * h * lq  # scores, over the batch
        scale = d ** -0.5
        got, lse = fa.flash_sdpa(q, k, v, bias, scale, return_lse=True)
        want, want_lse = fa.flash_sdpa_plain(q, k, v, bias, scale, return_lse=True)
        tol = 2e-2 if dt == "bf16" else 1e-4
        err = held(f"{dt} forward d={d} q {tuple(q.shape)} k {tuple(k.shape)}", got, want, lse,
                   want_lse, tol, 1e-2 if dt == "bf16" else 1e-4)
        del got, lse, want, want_lse
        torch.cuda.empty_cache()
        if err is None:
            continue
        if dt == "fp32":
            bms, by = cs.attn_bound(q.numel(), live, d, kv_elems=k.numel() + v.numel())
        else:
            nb = 2 * (q.numel() * 2 + 2 * live // lq * d) + 4 * bias.numel()
            bms, by = cs.bound(nb, 4.0 * live * d, 1.0 * live, 6.0 * live)
        fn = lambda: fa.flash_sdpa(q, k, v, bias, scale)  # noqa: E731
        ms = cs.graph_time(fn, 5, 10)
        call_ms = cs.cuda_time(fn, 10)
        _, _, dev_us = cs.profile_kernels(fn)
        plain_ms = cs.cuda_time(lambda: fa.flash_sdpa_plain(q, k, v, bias, scale), 2, warmup=1)
        mask = None if slots is None else (bias > fa.NEG_INF / 2)[:, None, None, :]
        lib = cs.graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 3, 5)
        print(f"[{label}] {dt} forward d={d} q {tuple(q.shape)} k {tuple(k.shape)} "
              f"{fa.sdpa_kernel(dtype, d)}: {ms:.4f} ms (CUDA graph) | call {call_ms:.4f} ms | "
              f"device {dev_us / 1e3:.4f} ms | plain {plain_ms:.4f} ms | SDPA {lib:.4f} ms | "
              f"bound {bms:.4f} ms ({by}) | max err {err:.3e} | {smi}", flush=True)
        del q, k, v, bias, mask
        torch.cuda.empty_cache()
    for slots, entries, dt in MEM:
        if only not in (None, dt) or q8:
            continue
        dtype = bf16 if dt == "bf16" else torch.float32
        q = torch.randn((8, 1, 5184, 256), generator=gen, device=dev).to(dtype)
        k = torch.randn((8, 36864, 256), generator=gen, device=dev).to(dtype)[:, None]
        v = torch.randn((8, 36864, 64), generator=gen, device=dev).to(dtype)[:, None]
        bias = torch.full((8, 36864), fa.NEG_INF, device=dev)
        bias[:slots, :entries * 5184] = 0.0
        live = int((bias > fa.NEG_INF / 2).sum().item())  # keys, over the slots
        scale = 256 ** -0.5
        got, lse = fa.flash_memattn(q, k, v, bias, scale, return_lse=True)
        want, want_lse = fa.flash_memattn_plain(q, k, v, bias, scale, return_lse=True)
        tol = 2e-2 if dt == "bf16" else 1e-4
        err = held(f"{dt} memattn {slots} slots x {entries} entries", got, want, lse, want_lse,
                   tol, 1e-2 if dt == "bf16" else 1e-4)
        del got, want, want_lse
        torch.cuda.empty_cache()
        if err is None:
            continue
        if dt == "fp32":
            bms, by = cs.attn_bound(q.numel(), live * 5184, 256, 64, live * (256 + 64))
        else:
            nb = 2 * (q.numel() + q.numel() // 4 + live * (256 + 64)) + 4 * (bias.numel() +
                                                                            lse.numel())
            bms, by = cs.bound(nb, 2.0 * 5184 * live * 320, 1.0 * 5184 * live,
                               6.0 * 5184 * live)
        fn = lambda: fa.flash_memattn(q, k, v, bias, scale, return_lse=True)  # noqa: E731
        ms = cs.graph_time(fn, 5, 10)
        call_ms = cs.cuda_time(fn, 10)
        _, _, dev_us = cs.profile_kernels(fn)
        plain_ms = cs.cuda_time(lambda: fa.flash_memattn_plain(q, k, v, bias, scale, True), 2,
                                warmup=1)
        bias4 = bias[:, None, None, :].to(dtype)
        lib = cs.graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias4, scale=scale), 3, 5)
        kernel = getattr(fa, "memattn_kernel", lambda _: "flash_memattn")(dtype)
        print(f"[{label}] {dt} memattn {slots} slots x {entries} entries ({live} live keys) "
              f"{kernel}: {ms:.4f} ms (CUDA graph) | call {call_ms:.4f} ms | device "
              f"{dev_us / 1e3:.4f} ms | plain {plain_ms:.4f} ms | SDPA {lib:.4f} ms | bound "
              f"{bms:.4f} ms ({by}) | max err {err:.3e} | {smi}", flush=True)
        del q, k, v, bias, bias4, lse
        torch.cuda.empty_cache()
    for slots, entries, dt in MEM:  # the same bank over int8 keys
        if only not in (None, dt):
            continue
        dtype = bf16 if dt == "bf16" else torch.float32
        q = torch.randn((8, 1, 5184, 256), generator=gen, device=dev).to(dtype)
        k_i8, ks = fa.quantize_rows(
            torch.randn((8, 36864, 256), generator=gen, device=dev).to(dtype))
        k_i8, ks = k_i8[:, None], ks[..., 0]
        v = torch.randn((8, 36864, 64), generator=gen, device=dev).to(dtype)[:, None]
        bias = torch.full((8, 36864), fa.NEG_INF, device=dev)
        bias[:slots, :entries * 5184] = 0.0
        live = int((bias > fa.NEG_INF / 2).sum().item())  # keys, over the slots
        scale = 256 ** -0.5
        what = f"{dt} memattn_q8 {slots} slots x {entries} entries"
        got, lse = fa.flash_memattn_q8(q, k_i8, ks, v, bias, scale, return_lse=True)
        want, want_lse = fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias, scale, return_lse=True)
        tol = 2e-2 if dt == "bf16" else 1e-4
        err = held(what, got, want, lse, want_lse, tol, 1e-2 if dt == "bf16" else 1e-4)
        if err is not None and not torch.equal(
                fa.flash_memattn_q8(q, k_i8, ks, v, bias, scale), got):
            print(f"[{label}] {what}: the output without the LSE differs | {smi}", flush=True)
            failed.append(what)
            err = None
        del got, want, want_lse
        torch.cuda.empty_cache()
        if err is None:
            continue
        # q and the output, the live keys (int8 rows, their scales and
        # biases) and values, the lse; the function's int8 and value
        # products, exponentials, ~8 FMA-pipe operations a score
        esz = q.element_size()
        nb = (esz * (q.numel() + q.numel() // 4) + live * (256 + 8 + esz * 64)
              + 4 * lse.numel())
        pv = {("tf32_flops" if dt == "fp32" else "mma_flops"): 2.0 * 5184 * live * 64}
        bms, by = cs.bound(nb, exps=1.0 * 5184 * live, fp32_ops=8.0 * 5184 * live,
                           int8_ops=2.0 * 5184 * live * 256, **pv)
        fn = lambda: fa.flash_memattn_q8(q, k_i8, ks, v, bias, scale, return_lse=True)  # noqa: E731
        ms = cs.graph_time(fn, 5, 10)
        call_ms = cs.cuda_time(fn, 10)
        _, _, dev_us = cs.profile_kernels(fn)
        plain_ms = cs.cuda_time(
            lambda: fa.flash_memattn_q8_plain(q, k_i8, ks, v, bias, scale, True), 2, warmup=1)
        k_deq = (k_i8.float() * ks[:, None, :, None]).to(dtype)
        exact_ms = cs.graph_time(
            lambda: fa.flash_memattn(q, k_deq, v, bias, scale, return_lse=True), 5, 10)
        bias4 = bias[:, None, None, :].to(dtype)
        lib = cs.graph_time(lambda: F.scaled_dot_product_attention(
            q, (k_i8.float() * ks[:, None, :, None]).to(dtype), v, attn_mask=bias4, scale=scale),
            3, 5)
        kernel = getattr(fa, "memattn_q8_kernel", lambda _: "flash_memattn_q8")(dtype)
        print(f"[{label}] {what} ({live} live keys) {kernel}: {ms:.4f} ms (CUDA graph) | call "
              f"{call_ms:.4f} ms | device {dev_us / 1e3:.4f} ms | plain {plain_ms:.4f} ms | exact "
              f"bank on the dequantized keys {exact_ms:.4f} ms | dequantize + SDPA {lib:.4f} ms | "
              f"bound {bms:.4f} ms ({by}) | max err {err:.3e} | {smi}", flush=True)
        del q, k_i8, ks, v, bias, bias4, lse, k_deq
        torch.cuda.empty_cache()
    for b, h, n, d, dt in BWD:
        if only not in (None, dt) or tracker or (q8 and (d, dt) != (32, "bf16")):
            continue
        dtype = bf16 if dt == "bf16" else torch.float32
        tol = 2e-2 if dt == "bf16" else 1e-4
        q, k, v = packed(b, h, n, d, dtype)
        bias = torch.zeros((b, n), device=dev)
        scale = d ** -0.5
        o, lse = fa.flash_sdpa_plain(q, k, v, bias, scale, return_lse=True)
        do = torch.randn((b, n, h * d), generator=gen, device=dev).to(dtype)
        do = do.reshape(b, n, h, d).transpose(1, 2)
        dq, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
        dq2, delta2 = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
        dk, dv = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
        dk2, dv2 = fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale)
        if not all(torch.equal(a, c) for a, c in ((dq, dq2), (delta, delta2), (dk, dk2),
                                                   (dv, dv2))):
            raise AssertionError(f"{dt} d={d}: a second run differs")
        want_dq, want_delta = fa.flash_sdpa_bwd_dq_plain(q, k, v, bias, o, lse, do, scale)
        err_dq = max(cs.check_rel(f"{dt} dq d={d}", dq, want_dq, tol),
                     cs.check(f"{dt} dq d={d} (delta)", delta, want_delta, 1e-4))
        del dq, dq2, delta2, want_dq
        want_dk, want_dv = fa.flash_sdpa_bwd_dkv_plain(q, k, v, bias, do, lse, want_delta, scale)
        err = max(cs.check_rel(f"{dt} dkv d={d} (dk)", dk, want_dk, tol),
                  cs.check_rel(f"{dt} dkv d={d} (dv)", dv, want_dv, tol))
        del dk, dv, dk2, dv2, want_dk, want_dv, want_delta
        torch.cuda.empty_cache()
        ms = cs.graph_time(lambda: fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale),
                           5, 10)
        ms_dq = cs.graph_time(lambda: fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale),
                              5, 10)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        lib = cs.cuda_time(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
                           10)
        print(f"[{label}] {dt} dkv d={d} {tuple(q.shape)} {fa.bwd_dkv_kernel(dtype, d)}: "
              f"{ms:.4f} ms (CUDA graph) | dq {fa.bwd_dq_kernel(dtype, d)} {ms_dq:.4f} ms | SDPA "
              f"backward {lib:.4f} ms a call | max abs err dkv {err:.3e}, dq {err_dq:.3e} | {smi}",
              flush=True)
        del q, k, v, o, lse, do, ol, ql, kl, vl
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"bench_vit_attn [{label}]: {len(failed)} kernel(s) disagree with "
                         f"their plain versions: {failed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout, timed in turns with this one")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default=None,
                    help="time only the shapes of this dtype")
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--tracker", action="store_true",
                     help="time only the tracker's shapes: the d=256 forwards and the bank")
    grp.add_argument("--q8", action="store_true",
                     help="time only the int8 bank and the bf16 d=32 backward pair")
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.other is None or args.label is not None:
        measure(args.label or "this", args.dtype, args.tracker, args.q8)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    rc = 0
    for where, label in ((other, "other"), (here, "this"), (here, "this"), (other, "other")):
        # the other checkout's misses are reported and its other kernels still timed
        run = subprocess.run([sys.executable, os.path.join(here, "bench_vit_attn.py"),
                              "--label", f"{label} ({os.path.relpath(where, here)})",
                              *(("--dtype", args.dtype) if args.dtype else ()),
                              *(("--tracker",) if args.tracker else ()),
                              *(("--q8",) if args.q8 else ())], cwd=where)
        if label == "this":
            rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
