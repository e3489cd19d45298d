"""Build and load the CUDA C++ kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``_build/`` (listed in
.gitignore), then loaded with ctypes. The first ``load`` builds every
source at once, one ``nvcc`` process per source started together, so a
fresh checkout pays the build once and in parallel. Library file names
carry a hash of the sources, so an edited kernel is rebuilt, never stale.

Nothing here runs at import time, and nothing falls back: a failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ticket buffers by (device index, stream handle): outside capture, one a
# stream; during a CUDA-graph capture, one a stream and capture (with its id)
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_captured: dict[tuple[int, int], tuple[int, torch.Tensor]] = {}
_tickets_lock = threading.Lock()
TICKETS = 4096


def _find_nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing; return the ptxas
    report (registers, shared memory, spills) of each compiled source."""
    digest = _digest()
    todo = [n for n in sources() if not _lib_path(n, digest).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(name, digest))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name, _digest())))
            _libs[name] = lib
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of a host-only source (``csrc/hungarian.cu``,
    ``csrc/hostkernels.cu``: plain C++ without device code). With nvcc it is
    built with the kernels (``load``); on a machine without nvcc the same
    file is compiled by g++. No compiler, or a failed build, raises."""
    if _find_nvcc() is not None:
        return load(name)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name, _digest())
            if not path.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError(f"neither nvcc nor g++ found: csrc/{name}.cu cannot be built")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.run(
                    [gxx, "-O3", "-shared", "-fPIC", "-pthread", "-x", "c++", "-o", tmp,
                     str(CSRC / f"{name}.cu")], capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"g++ {name}.cu failed:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def _lib_capture():
    """``stream_capture_id`` of csrc/stream_capture.cu: the stream, and the
    int and unsigned 64-bit integer it writes."""
    fn = load("stream_capture").stream_capture_id
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def _capture_id(stream: int):
    """The id of the CUDA-graph capture the stream is in, or None."""
    capturing, ident = ctypes.c_int(), ctypes.c_ulonglong()
    check(_lib_capture()(stream, ctypes.byref(capturing), ctypes.byref(ident)),
          "stream_capture_id")
    return ident.value if capturing.value else None


def tickets(device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of TICKETS tickets for one launch on the
    device's current stream, of a kernel whose last block to finish takes
    an atomic ticket (the depthwise, LayerNorm and RMSNorm backward
    kernels). Each launch leaves the tickets it took at 0 again, so a
    buffer is safe for launches that run one after another, and no more:

    - outside capture, each (device, stream) has a buffer of its own, made
      zero-filled on that stream at its first use: launches on one stream
      run in turn, launches on two streams never share a ticket;
    - during a CUDA-graph capture, each (device, stream) of each capture
      has a buffer of its own, allocated from the graph's private pool, so
      its zero fill is a node of the graph that every replay runs before
      the captured launches that take it. A replay never reads a buffer of
      eager launches or of another graph, and the buffer lives as long as
      the graph's pool holds it; the last capture's is let go at the
      stream's next launch outside capture.

    n, the tickets a launch takes, must fit."""
    if n > TICKETS:
        raise ValueError(f"a launch takes {n} tickets, more than the buffer's {TICKETS}")
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    capture = _capture_id(stream)
    key = (device.index, stream)
    with _tickets_lock:
        if capture is None:
            _captured.pop(key, None)
            buf = _tickets.get(key)
            if buf is None:
                buf = _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32, device=device)
            return buf
        held = _captured.get(key)
        if held is None or held[0] != capture:
            held = _captured[key] = (
                capture, torch.zeros(TICKETS, dtype=torch.int32, device=device))
        return held[1]


def ticket_buffers() -> list[torch.Tensor]:
    """Every ticket buffer made outside capture (each is 0 between
    launches)."""
    with _tickets_lock:
        return list(_tickets.values())


def needs_grad(*tensors) -> bool:
    """True when autograd records this call: grad mode is on and an input
    requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """A forward-only kernel's output would be cut from the autograd graph:
    raise instead of returning it."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} kernel is forward-only: an input requires a gradient. Run it under "
            "torch.no_grad(), or take the differentiable path (the module's training mode)")
