"""Minimal TensorBoard event-file writer, dependency-free
(``cm3_tpu.train.tboard``).

The reference registers loss scalars plus per-variable / per-gradient
histograms with ``tf.summary`` and a ``tf.summary.FileWriter``
(``alg/alg_credit.py:362-403``, ``alg/train_offpolicy.py:176,350-356``).
This writes the TFRecord-framed Event protos that TensorBoard reads,
hand-encoded (scalar + histogram summaries only), so runs are
inspectable with stock ``tensorboard --logdir log/`` without TensorFlow
or TensorBoard anywhere in the port.  The encoding is the JAX package's,
byte for byte: the same events for the same values, steps and wall
times.

Wire format (TFRecord): ``uint64 len | uint32 masked_crc32c(len) |
bytes data | uint32 masked_crc32c(data)``; protos per
tensorflow/core/util/event.proto and framework/summary.proto.

``log_train_state`` writes a port state under the names and in the
order that JAX's ``log_train_state`` gives the JAX state of the same
algorithm (``convert.jax_leaves``: every float leaf of the flax struct,
in flax layout, so that a histogram's sums add in JAX's order), and
``log_grads`` the gradients of ``update(..., with_grads=True)``.  Each
reads the state to the host in one copy.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from cm3_tpu_torch import convert

# ----------------------------------------------------------------------- #
# CRC32C (Castagnoli), table-driven; TFRecord framing needs the masked form.

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
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
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ----------------------------------------------------------------------- #
# Hand-rolled protobuf encoding (wire types: 0 varint, 1 fixed64,
# 2 length-delimited, 5 fixed32).


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _packed_f64(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _bytes(field, payload)


def _histo_proto(values: np.ndarray) -> bytes:
    """HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    bucket_limit=6 bucket=7, with TF's ~1.1-growth exponential buckets."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros(1)
    # TF-style limits: +-1e-12 * 1.1^k, mirrored, plus a huge sentinel
    limits = [1e-12]
    while limits[-1] < 1e20:
        limits.append(limits[-1] * 1.1)
    limits = [-x for x in reversed(limits)] + limits + [1.7e308]
    limits = np.asarray(limits)
    counts, _ = np.histogram(v, np.concatenate([[-1.7e308], limits]))
    nz = np.nonzero(counts)[0]
    if nz.size:                      # trim empty tails, keep one pad bucket
        lo, hi = max(nz[0] - 1, 0), min(nz[-1] + 1, len(counts) - 1)
        limits, counts = limits[lo:hi + 1], counts[lo:hi + 1]
    return (_f64(1, float(v.min())) + _f64(2, float(v.max()))
            + _f64(3, float(v.size)) + _f64(4, float(v.sum()))
            + _f64(5, float((v * v).sum()))
            + _packed_f64(6, limits) + _packed_f64(7, counts))


def _event(step: int, summary_values: bytes) -> bytes:
    # Event: wall_time=1(double) step=2(int64) summary=5
    return (_f64(1, time.time()) + _i64(2, step)
            + _bytes(5, summary_values))


# ----------------------------------------------------------------------- #


class SummaryWriter:
    """Append-only TensorBoard event file: ``scalar`` and ``histogram``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self._f = open(os.path.join(log_dir, fname), "wb")
        # first record: file version header
        self._write(_f64(1, time.time()) + _bytes(3, b"brain.Event:2"))

    def _write(self, event_bytes: bytes):
        hdr = struct.pack("<Q", len(event_bytes))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr))
                      + event_bytes
                      + struct.pack("<I", _masked_crc(event_bytes)))

    def scalar(self, tag: str, value: float, step: int):
        val = _bytes(1, tag.encode()) + _f32(2, float(value))
        self._write(_event(step, _bytes(1, val)))

    def histogram(self, tag: str, values, step: int):
        val = _bytes(1, tag.encode()) + _bytes(5, _histo_proto(values))
        self._write(_event(step, _bytes(1, val)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def log_train_state(writer: SummaryWriter, ts, step: int,
                    prefix: str = "vars", seed: Optional[int] = None):
    """Per-variable histograms over every float leaf of an algorithm's
    state (``seed``: one seed of a seed-stacked state), as JAX's
    ``log_train_state`` writes the JAX state (the reference's
    per-variable ``tf.summary.histogram`` loop, alg_credit.py:377-390)."""
    for name, leaf in convert.jax_leaves(ts, seed):
        writer.histogram(f"{prefix}/{name}", leaf, step)


def log_grads(writer: SummaryWriter, ts, grads, step: int,
              prefix: str = "grads", seed: Optional[int] = None):
    """Per-gradient histograms of ``grads`` (``metrics["grads"]`` of an
    update of ``ts``'s algorithm), as JAX's ``log_train_state`` writes
    its gradient pytrees (alg_credit.py:384-403)."""
    for name, leaf in convert.jax_grad_leaves(ts, grads, seed):
        writer.histogram(f"{prefix}/{name}", leaf, step)
