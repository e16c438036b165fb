"""Digest-verified mutation log (write-ahead log) of the streaming mutable
index (port of ``repro.checkpoint.wal``), byte-compatible with the
reference's: the same mutations logged by either package give identical
files, and each package replays the other's log.

The base snapshot (``CheckpointManager.save_named`` / ``index_io``) holds
a full, atomic, digest-verified image of the index; this module holds the
delta, an append-only log of every mutation applied since.  Recovery is
rebuilding or restoring the base, then :func:`replay_into` of the log.
The serving loop appends a record *before* it applies the mutation, so
after any crash the live state equals the replay of the log's complete
records, including under the ``torn_upsert`` chaos fault, which truncates
a record mid-write as a crash would.

On-disk format, per record::

    [4-byte big-endian payload length][payload][32-byte sha256(payload)]

The payload is ``json.dumps(record, sort_keys=True)`` in UTF-8; arrays
travel as ``{"dtype", "shape", "data"}`` with ``data`` the base64 of their
raw little-endian bytes (a tensor is copied to a contiguous numpy array
first; an upsert's vector as float32), so replayed vectors are bit for bit
what was logged.  Opening a log scans it whole:

  * a clean log yields its records and positions the append cursor;
  * an incomplete tail record (a torn write: the crash case) is TRUNCATED
    and reported as ``recovered_torn`` — its mutation was never applied;
  * a digest mismatch on a complete record is corruption, not a crash:
    ``IOError``, nothing guessed.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import struct
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.calibration import EpsilonTable
from repro_torch.runtime.chaos import ChaosError, current_chaos

__all__ = ["MutationLog", "replay_into"]

_LEN = struct.Struct(">I")
_DIGEST_BYTES = 32
_MAX_RECORD = 1 << 30


def _numpy(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=dtype))


def _pack_array(a: np.ndarray) -> dict[str, Any]:
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _unpack_array(spec: dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(spec["data"])
    return np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).reshape(
        spec["shape"]).copy()


class MutationLog:
    """Append-only, digest-verified mutation log.

    ``append`` honours the ``torn_upsert`` chaos fault: when armed it
    writes a prefix of the record (length header and half the payload),
    fsyncs the torn bytes so the drill survives the process, and raises
    ``ChaosError`` — the crash the next opener recovers from."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.seq = 0  # last sequence number present in the log
        self.records_written = 0
        self.recovered_torn = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        valid_end = 0
        if os.path.exists(path):
            for _, end in self._scan():
                valid_end = end
            if os.path.getsize(path) != valid_end:
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
                self.recovered_torn = True
        self._f = open(path, "ab")

    # ---- read side -------------------------------------------------------

    def _scan(self) -> Iterator[tuple[dict, int]]:
        """``(record, end_offset)`` of every COMPLETE record, tracking
        ``self.seq``; stops at a torn tail, raises ``IOError`` on a digest
        mismatch of a complete record."""
        with open(self.path, "rb") as f:
            off = 0
            while True:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    return  # EOF or a torn length header
                (ln,) = _LEN.unpack(head)
                if ln == 0 or ln > _MAX_RECORD:
                    raise IOError(f"wal {self.path}: corrupt record length {ln} "
                                  f"at offset {off}")
                body = f.read(ln + _DIGEST_BYTES)
                if len(body) < ln + _DIGEST_BYTES:
                    return  # a torn payload or digest: an incomplete write
                payload, digest = body[:ln], body[ln:]
                if hashlib.sha256(payload).digest() != digest:
                    raise IOError(f"wal {self.path}: digest mismatch at offset "
                                  f"{off} (corrupt record)")
                rec = json.loads(payload.decode("utf-8"))
                off += _LEN.size + ln + _DIGEST_BYTES
                self.seq = max(self.seq, int(rec.get("seq", 0)))
                yield rec, off

    def replay(self, *, after_seq: int = 0) -> list[dict]:
        """Every complete record with ``seq > after_seq``, arrays decoded."""
        out = []
        for rec, _ in self._scan():
            if int(rec["seq"]) <= after_seq:
                continue
            if "vec" in rec:
                rec = dict(rec, vec=_unpack_array(rec["vec"]))
            if "table" in rec:
                rec = dict(rec, table={k: _unpack_array(v)
                                       for k, v in rec["table"].items()})
            out.append(rec)
        return out

    # ---- write side ------------------------------------------------------

    def _append(self, rec: dict) -> int:
        self.seq += 1
        rec = dict(rec, seq=self.seq)
        payload = json.dumps(rec, sort_keys=True).encode("utf-8")
        digest = hashlib.sha256(payload).digest()
        if current_chaos().take_torn_upsert() is not None:
            torn = _LEN.pack(len(payload)) + payload[: max(1, len(payload) // 2)]
            self._f.write(torn)
            self._f.flush()
            os.fsync(self._f.fileno())
            self.seq -= 1  # the record does not exist; replay never sees it
            raise ChaosError(f"injected torn upsert (wal record {self.seq + 1} "
                             f"truncated mid-write)")
        self._f.write(_LEN.pack(len(payload)) + payload + digest)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.records_written += 1
        return self.seq

    def append_upsert(self, gid: int, vec) -> int:
        return self._append({"op": "upsert", "id": int(gid),
                             "vec": _pack_array(_numpy(vec, np.float32))})

    def append_delete(self, gid: int) -> int:
        return self._append({"op": "delete", "id": int(gid)})

    def append_set_table(self, table) -> int:
        """Log a recalibration swap: replay reproduces the serving
        estimator's history too."""
        return self._append({"op": "set_table", "table": {
            "dims": _pack_array(_numpy(table.dims, np.int32)),
            "eps": _pack_array(_numpy(table.eps, np.float32)),
            "scale": _pack_array(_numpy(table.scale, np.float32)),
            "eps_lo": _pack_array(_numpy(table.eps_lo, np.float32)),
        }})

    def close(self) -> None:
        self._f.close()


def replay_into(target, records) -> dict[str, int]:
    """Apply decoded WAL records to a mutable index (anything with
    ``upsert``/``delete``/``set_estimator``/``estimator``).  Upsert ids are
    held against the log: a divergence means the base snapshot is not the
    log's origin.  Returns the op counts."""
    counts = {"upsert": 0, "delete": 0, "set_table": 0}
    for rec in records:
        op = rec["op"]
        if op == "upsert":
            got = target.upsert(rec["vec"])
            if got != int(rec["id"]):
                raise ValueError(
                    f"wal replay diverged: upsert seq {rec['seq']} expected id "
                    f"{rec['id']}, index assigned {got} (wrong base snapshot?)")
        elif op == "delete":
            target.delete(int(rec["id"]))
        elif op == "set_table":
            t = rec["table"]
            dev = target.estimator.table.eps.device
            table = EpsilonTable(
                dims=torch.as_tensor(t["dims"], device=dev),
                eps=torch.as_tensor(t["eps"], device=dev),
                scale=torch.as_tensor(t["scale"], device=dev),
                eps_lo=torch.as_tensor(t["eps_lo"], device=dev))
            target.set_estimator(dataclasses.replace(target.estimator, table=table))
        else:
            raise ValueError(f"wal replay: unknown op {op!r}")
        counts[op] += 1
    return counts
