"""Logging, meters and metrics writers of the training driver.

Counterpart of efficientsam3_tpu/utils/observability.py (its JAX-free
part): the package logger, running-average meters, and a metrics sink that
writes JSONL and TensorBoard event files with a hand-written encoder
(Event protos in TFRecord framing, CRC32-C in Python), so no TensorBoard
or TensorFlow package is needed.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import time
from collections import defaultdict
from typing import Optional

LOG = logging.getLogger("efficientsam3_tpu_torch")
if not LOG.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    LOG.addHandler(_h)
    LOG.setLevel(logging.INFO)


class Meter:
    """Running average of a scalar."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.last = 0.0

    def update(self, value: float, n: int = 1):
        self.last = float(value)
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MeterBank:
    """Named meters plus an ETA from the wall time since construction."""

    def __init__(self):
        self.meters = defaultdict(Meter)
        self._t0 = time.perf_counter()

    def update(self, **values):
        for k, v in values.items():
            self.meters[k].update(float(v))

    def log(self, step: int, total_steps: Optional[int] = None):
        parts = [f"step {step}"]
        if total_steps:
            rate = (time.perf_counter() - self._t0) / max(step, 1)
            parts.append(f"eta {rate * (total_steps - step) / 60:.1f}m")
        parts += [f"{k} {m.avg:.4f}" for k, m in self.meters.items()]
        LOG.info("  ".join(parts))


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if (c & 1) else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC32-C (Castagnoli), which the TFRecord framing requires."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_bytes(num: int, payload: bytes) -> bytes:
    return _pb_field(num, 2) + _varint(len(payload)) + payload


class TensorBoardWriter:
    """Scalar events in an ``events.out.tfevents.*`` file that TensorBoard
    reads natively."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_event(self._event(wall_time=time.time(), file_version=True))

    @staticmethod
    def _event(wall_time, step=None, scalars=None, file_version=False) -> bytes:
        ev = _pb_field(1, 1) + struct.pack("<d", wall_time)  # wall_time: double
        if file_version:
            return ev + _pb_bytes(3, b"brain.Event:2")
        if step is not None:
            ev += _pb_field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
        if scalars:
            values = b""
            for tag, val in scalars.items():
                v = _pb_bytes(1, tag.encode()) + _pb_field(2, 5) + struct.pack("<f", float(val))
                values += _pb_bytes(1, v)  # Summary.value
            ev += _pb_bytes(5, values)  # Event.summary
        return ev

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def write_scalars(self, step: int, scalars: dict):
        self._write_event(self._event(wall_time=time.time(), step=step, scalars=scalars))

    def close(self):
        self._f.close()


class MetricsWriter:
    """JSONL metrics log + TensorBoard event files under one logdir."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = TensorBoardWriter(logdir)

    def write(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._tb.write_scalars(step, metrics)

    def close(self):
        self._jsonl.close()
        self._tb.close()
