"""Every ctypes binding of the port against the C entry point it calls.

The kernels in ``efficientsam3_tpu_torch/csrc/`` export plain C functions,
loaded with ctypes (``ops/_build.py``). A wrong ``argtypes`` list there
passes arguments in the wrong slots or cuts a pointer to 32 bits, and shows
only on the card. Here each binding's accessor runs against a stand-in for
the loaded library, and the argument types it sets are held against the
parameters of the ``extern "C"`` definition in the source: the library it
loads, the count, and each parameter's kind (pointer, 32- or 64-bit
integer, float). Runs on the CPU: nothing is compiled.
"""

import ctypes
import re
from pathlib import Path

import pytest

from efficientsam3_tpu_torch import native
from efficientsam3_tpu_torch.ops import _build, depthwise, hungarian, mma_probe
from efficientsam3_tpu_torch.ops import rms_norm as rn
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.ops import layer_norm as ln

CSRC = Path(_build.CSRC)
# C entry points of the device sources (one library a source): the
# accessor that binds each
BINDINGS = {
    "flash_sdpa_h_fwd": fa._lib_sdpa_h,
    "flash_sdpa_h_attrs": fa._lib_sdpa_h_attrs,
    "flash_sdpa_h_f32_fwd": fa._lib_sdpa_h_f32,
    "flash_sdpa_h_f32_attrs": fa._lib_sdpa_h_f32_attrs,
    "flash_sdpa_bwd_dkv_h": fa._lib_bwd_h,
    "flash_sdpa_bwd_dkv_h_attrs": fa._lib_bwd_h_attrs,
    "flash_sdpa_bwd_dq_h": fa._lib_bwd_dq_h,
    "flash_sdpa_bwd_dq_h_attrs": fa._lib_bwd_dq_h_attrs,
    "flash_sdpa_bwd_dkv_h_f32": fa._lib_bwd_h_f32,
    "flash_sdpa_bwd_dkv_h_f32_attrs": fa._lib_bwd_h_f32_attrs,
    "flash_sdpa_bwd_dq_h_f32": fa._lib_bwd_dq_h_f32,
    "flash_sdpa_bwd_dq_h_f32_attrs": fa._lib_bwd_dq_h_f32_attrs,
    "flash_sdpa_bwd_dq_wide_h": lambda: fa._lib_bwd_wide_h("flash_sdpa_bwd_dq_wide_h"),
    "flash_sdpa_bwd_dkv_wide_h": lambda: fa._lib_bwd_wide_h("flash_sdpa_bwd_dkv_wide_h"),
    "flash_sdpa_bwd_dq_wide_h_attrs": fa._lib_bwd_wide_h_dq_attrs,
    "flash_sdpa_bwd_dkv_wide_h_attrs": fa._lib_bwd_wide_h_dkv_attrs,
    "flash_sdpa_bwd_dq_wide_f32": lambda: fa._lib_bwd_wide_f32("flash_sdpa_bwd_dq_wide_f32"),
    "flash_sdpa_bwd_dkv_wide_f32": lambda: fa._lib_bwd_wide_f32("flash_sdpa_bwd_dkv_wide_f32"),
    "flash_sdpa_bwd_dq_wide_f32_attrs": fa._lib_bwd_wide_f32_dq_attrs,
    "flash_sdpa_bwd_dkv_wide_f32_attrs": fa._lib_bwd_wide_f32_dkv_attrs,
    "flash_sdpa_split_parts": fa._lib_split_parts,
    "flash_memattn_h_fwd": fa._lib_memattn_h,
    "flash_memattn_h_f32_fwd": fa._lib_memattn_h_f32,
    "flash_memattn_h_attrs": fa._lib_memattn_h_attrs,
    "flash_memattn_q8_h_fwd": fa._lib_memattn_q8_h,
    "flash_memattn_q8_h_f32_fwd": fa._lib_memattn_q8_h_f32,
    "flash_memattn_q8_h_attrs": fa._lib_memattn_q8_h_attrs,
    "flash_xattn_rpb_fwd": fa._lib_xattn,
    "flash_xattn_rpb_attrs": fa._lib_xattn_attrs,
    "layer_norm_fwd": ln._lib_fwd,
    "layer_norm_fwd_attrs": ln._lib_fwd_attrs,
    "layer_norm_bwd": ln._lib_bwd,
    "layer_norm_bwd_attrs": ln._lib_bwd_attrs,
    "rms_norm_bwd": rn._lib_bwd,
    "rms_norm_bwd_attrs": rn._lib_bwd_attrs,
    "depthwise_conv2d_fwd": depthwise._lib_fwd,
    "depthwise_conv2d_bwd": depthwise._lib_bwd,
    "depthwise_conv2d_attrs": depthwise._lib_attrs,
    "mma_probe_dot_chain": mma_probe._lib,
    "mma_probe_attrs": mma_probe._lib_attrs,
    "stream_capture_id": _build._lib_capture,
    "hungarian_solve": hungarian._lib,
}


def _kind_c(param):
    p = " ".join(param.split())
    if "*" in p:
        return "ptr"
    if "long long" in p or "int64_t" in p:
        return "i64"
    if "double" in p:
        return "f64"
    if "float" in p:
        return "f32"
    if "int" in p:
        return "i32"
    raise ValueError(f"unknown C parameter type: {param!r}")


def _kind_ctypes(t):
    if t in (ctypes.c_void_p, ctypes.c_char_p):
        return "ptr"
    if t is ctypes.c_float:
        return "f32"
    if t is ctypes.c_double:
        return "f64"
    return {4: "i32", 8: "i64"}[ctypes.sizeof(t)]


def _params(text):
    text = text.strip()
    return [] if text in ("", "void") else [p for p in text.split(",")]


def _device_entries():
    """{name: (source stem, [parameter kinds])} of every `extern "C" int`
    definition in the sources nvcc builds."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[name] = (path.stem, [_kind_c(p) for p in _params(params)])
    return out


def _host_entries():
    """{name: [parameter declarations]} of the functions in
    hostkernels.cu's `extern "C" { ... }` block."""
    text = re.sub(r"//[^\n]*", "", (CSRC / "hostkernels.cu").read_text())
    block = text[text.index('extern "C" {'):]
    return {name: _params(params)
            for name, params in re.findall(
                r"^(?:int32_t|int64_t|int|void)\s+(\w+)\(([^)]*)\)\s*\{", block, re.M)}


DEVICE = _device_entries()
HOST = _host_entries()


class _FakeFn:
    def __init__(self, source, name):
        self.source, self.name = source, name
        self.argtypes = self.restype = None


class _FakeLib:
    def __init__(self, source):
        self.source, self.fns = source, {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _FakeFn(self.source, name))


@pytest.fixture
def fake_libs(monkeypatch):
    libs = {}
    fake = lambda source: libs.setdefault(source, _FakeLib(source))  # noqa: E731
    monkeypatch.setattr(_build, "load", fake)
    monkeypatch.setattr(_build, "load_host", fake)
    return libs


def test_every_device_entry_point_is_bound():
    """Each `extern "C"` function of the nvcc-built sources has a binding
    above, and each binding names a function the sources define."""
    assert set(DEVICE) == set(BINDINGS)


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_device_binding_matches_its_source(fake_libs, name):
    fn = BINDINGS[name]()
    source, kinds = DEVICE[name]
    assert (fn.source, fn.name) == (source, name)
    assert fn.argtypes is not None and fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(kinds), (
        f"{name}: {len(fn.argtypes)} argtypes, {len(kinds)} parameters in csrc/{source}.cu")
    assert [_kind_ctypes(t) for t in fn.argtypes] == kinds


@pytest.mark.parametrize("name", sorted(native._SIGNATURES))
def test_host_binding_matches_its_source(fake_libs, name):
    lib = native.lib()
    fn = getattr(lib, name)
    assert lib.source == "hostkernels" and name in HOST
    assert len(fn.argtypes) == len(HOST[name])
    assert [_kind_ctypes(t) for t in fn.argtypes] == [_kind_c(p) for p in HOST[name]]
