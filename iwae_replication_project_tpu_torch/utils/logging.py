"""Metrics logging: JSONL plus a dependency-free TensorBoard event writer
(port of ``utils/logging.py``; the module is framework-free, so this is a
copy).

The reference logs 7 scalars per eval via ``tf.summary.scalar``
(flexible_IWAE.py:529-545). TensorFlow is not a dependency, so the
TensorBoard event-file format (length-prefixed, masked-crc32c-framed Event
protos) is written directly, and any stock TensorBoard reads the result. A
JSONL stream of the same scalars is always written alongside.
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — needed for TB record framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding for tensorboard Event/Summary
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_event(wall_time: float, step: int, tag: Optional[str] = None,
                  value: Optional[float] = None,
                  file_version: Optional[str] = None) -> bytes:
    ev = bytearray()
    ev += _field(1, 1) + struct.pack("<d", wall_time)          # wall_time: double
    if step:
        ev += _field(2, 0) + _varint(step)                      # step: int64
    if file_version is not None:
        fv = file_version.encode()
        ev += _field(3, 2) + _varint(len(fv)) + fv              # file_version
    if tag is not None:
        tag_b = tag.encode()
        val = (_field(1, 2) + _varint(len(tag_b)) + tag_b       # Value.tag
               + _field(2, 5) + struct.pack("<f", value))       # Value.simple_value
        summ = _field(1, 2) + _varint(len(val)) + val           # Summary.value
        ev += _field(5, 2) + _varint(len(summ)) + summ          # Event.summary
    return bytes(ev)


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class TensorBoardWriter:
    """Append-only `events.out.tfevents.*` writer readable by TensorBoard."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.iwae_torch"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._f.write(_record(_encode_event(time.time(), 0,
                                            file_version="brain.Event:2")))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(_record(_encode_event(time.time(), step, tag=tag,
                                            value=float(value))))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class MetricsLogger:
    """JSONL + TensorBoard scalar logging with the reference's 7-scalar schema
    (flexible_IWAE.py:539-545) plus anything else handed to :meth:`log`.

    ``flush_every`` is the disk-sync cadence in rows: the default (1) keeps
    the historical flush-per-row behavior the staged driver's 8 rows/run
    never noticed, while high-frequency telemetry export (per-step rows,
    serving snapshots) sets it higher so each ``log`` call does not pay two
    fsync-ish flushes; :meth:`close` (and :meth:`flush`) always drain, so no
    cadence loses rows on an orderly shutdown.
    """

    def __init__(self, logdir: str, run_name: str = "run",
                 tensorboard: bool = True, flush_every: int = 1):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.dir = os.path.join(logdir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = TensorBoardWriter(self.dir) if tensorboard else None
        self.flush_every = flush_every
        self._since_flush = 0

    def log(self, metrics: Dict[str, float], step: int):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float)) or hasattr(v, "item")})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("step", "time"):
                    continue
                self._tb.scalar(k, v, step)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def log_registry(self, registry, step: int, prefix: str = ""):
        """Stamp a telemetry-registry snapshot (telemetry/registry.py) as one
        flat row: counters/gauges verbatim, histograms as ``name/stat``."""
        self.log(registry.rows(prefix=prefix), step=step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()
        self._since_flush = 0

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
