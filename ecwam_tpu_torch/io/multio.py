"""WAM_MULTIO / FDB output sink (wam_multio_mod.F90:66-99 role).

Copied unchanged from ``ecwam_tpu/io/multio.py`` (numpy only, no
JAX), with its imports pointed at ``ecwam_tpu_torch``: the port
imports nothing of the JAX package.

The reference routes encoded GRIB messages either to plain files or,
operationally, through the multio layer into the FDB (Fields DataBase):
``WAM_MULTIO_WRITE(grib)`` per message + ``WAM_MULTIO_FLUSH`` at output
epochs.  This module provides the same sink surface natively:

  * :class:`MultioSink` — write(message, key)/flush()/close() with
    write-behind buffering, flushing to an on-disk keyed store.
  * :class:`FdbLite` — the store: one content file per flush epoch plus
    an append-only JSONL index mapping GRIB-ish keys (param, date,
    step, ...) to (file, offset, length); retrieve()/list_keys() do
    keyed lookup like ``fdb-read``.

The writer-rank round-robin (IPFGTBL) composes with this: each writer
rank owns its own sink; the index files merge by concatenation.
"""

from __future__ import annotations

import json
import os


class FdbLite:
    """Keyed message database: flat content files + JSONL index."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.index_path = os.path.join(root, "index.jsonl")

    # -- write side ------------------------------------------------------
    def archive(self, entries) -> None:
        """``entries``: iterable of (key: dict, message: bytes)."""
        entries = list(entries)
        if not entries:
            return
        n = 0
        while True:
            data_name = f"data.{n:06d}"
            path = os.path.join(self.root, data_name)
            if not os.path.exists(path):
                break
            n += 1
        recs = []
        with open(path, "wb") as f:
            for key, msg in entries:
                off = f.tell()
                f.write(msg)
                recs.append(dict(key=key, file=data_name, offset=off,
                                 length=len(msg)))
        with open(self.index_path, "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")

    # -- read side -------------------------------------------------------
    def _index(self):
        if not os.path.exists(self.index_path):
            return []
        with open(self.index_path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def list_keys(self):
        return [r["key"] for r in self._index()]

    def retrieve(self, **key) -> list:
        """All messages whose key contains ``key`` as a sub-dict."""
        out = []
        for r in self._index():
            if all(r["key"].get(k) == v for k, v in key.items()):
                with open(os.path.join(self.root, r["file"]), "rb") as f:
                    f.seek(r["offset"])
                    out.append(f.read(r["length"]))
        return out


class MultioSink:
    """WAM_MULTIO_WRITE/FLUSH surface over :class:`FdbLite`."""

    def __init__(self, root: str):
        self.db = FdbLite(root)
        self._pending: list = []

    def write(self, message: bytes, **key) -> None:
        """WAM_MULTIO_WRITE: buffer one encoded GRIB message."""
        self._pending.append((dict(key), bytes(message)))

    def flush(self) -> None:
        """WAM_MULTIO_FLUSH: commit the buffered epoch."""
        self.db.archive(self._pending)
        self._pending = []

    def close(self) -> None:
        self.flush()


def write_fields_to_sink(sink: MultioSink, fields: dict, blk, grid,
                         date14: str, edition: int = 1) -> None:
    """GRIB-encode ``fields`` (name → (n_real,) values) into the sink —
    the outwint.F90:118-120 path with LFDB true."""
    from ecwam_tpu_torch.io import gribout
    from ecwam_tpu_torch.io import outcontrol
    for name, vals in fields.items():
        msg = gribout.encode_field(name, vals, blk, grid, date14,
                                   edition=edition)
        pid = None
        p = outcontrol.BY_NAME.get(name)
        if p is not None:
            pid = p.paramid
        sink.write(msg, param=name, paramId=pid, date=date14,
                   edition=edition)
    sink.flush()
