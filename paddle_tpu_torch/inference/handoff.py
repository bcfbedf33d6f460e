"""Prefill -> decode KV handoff wire format, the port's copy of
`paddle_tpu/inference/handoff.py`: the same bytes for the same arrays and
meta, so a prefill replica of either package can hand a prompt's K/V
history to a decode replica of the other.

    b"PTKV" | <u32 manifest_len> | manifest JSON | data stream

The data stream is the snapshot data format (`resilience/snapshot.py:
pack_stream`: sorted-name concatenated np.save records), and the manifest
carries the per-var locators ({offset, bytes, dtype, shape, crc32}) plus
a free-form `meta` dict (cursor: prompt length, last token, max_new, seq
id). A truncated or bit-flipped blob raises `HandoffError`; the server
answers it with a 400 and the sender resends its immutable copy.
Arrays are host numpy: the decode service lands them on its device.
"""

from __future__ import annotations

import io as _io
import json
import struct
import zlib

import numpy as np

from ..resilience.snapshot import FORMAT_VERSION, pack_stream

__all__ = ["HandoffError", "pack_handoff", "unpack_handoff",
           "CONTENT_TYPE", "MAGIC"]

MAGIC = b"PTKV"
CONTENT_TYPE = "application/x-paddle-handoff"
_HEADER = struct.Struct("<I")  # manifest byte length


class HandoffError(Exception):
    """Corrupt, truncated, or foreign handoff frame."""


def pack_handoff(arrays: dict, meta: dict = None) -> bytes:
    """Serialize `arrays` (name -> array-like) + `meta` into one handoff
    blob. The tensor payload goes through snapshot.pack_stream, so the
    per-var crc32/offset bookkeeping is byte-identical to a snapshot's
    state.bin."""
    buf = _io.BytesIO()
    entries, total = pack_stream(buf, arrays)
    manifest = {
        "version": FORMAT_VERSION,
        "data_bytes": total,
        "vars": entries,
        "meta": dict(meta or {}),
    }
    mbytes = json.dumps(manifest).encode("utf-8")
    return MAGIC + _HEADER.pack(len(mbytes)) + mbytes + buf.getvalue()


def unpack_handoff(blob: bytes):
    """Parse + verify a handoff blob -> (arrays, meta). Every var's
    length and crc32 are checked; any mismatch raises HandoffError (the
    caller retries the transfer — never admits a torn history)."""
    if len(blob) < len(MAGIC) + _HEADER.size:
        raise HandoffError(f"handoff frame too short ({len(blob)} bytes)")
    if blob[:len(MAGIC)] != MAGIC:
        raise HandoffError("bad handoff magic")
    (mlen,) = _HEADER.unpack_from(blob, len(MAGIC))
    mstart = len(MAGIC) + _HEADER.size
    if len(blob) < mstart + mlen:
        raise HandoffError("truncated handoff manifest")
    try:
        manifest = json.loads(blob[mstart:mstart + mlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise HandoffError(f"unparseable handoff manifest: {e}") from e
    if manifest.get("version") != FORMAT_VERSION:
        raise HandoffError(
            f"handoff format version {manifest.get('version')!r} "
            f"(want {FORMAT_VERSION})")
    data = blob[mstart + mlen:]
    if len(data) != manifest.get("data_bytes"):
        raise HandoffError(
            f"handoff data stream is {len(data)} bytes, manifest says "
            f"{manifest.get('data_bytes')}")
    arrays = {}
    for name, ent in manifest.get("vars", {}).items():
        rec = data[ent["offset"]:ent["offset"] + ent["bytes"]]
        if len(rec) != ent["bytes"]:
            raise HandoffError(f"truncated record for var {name!r}")
        if (zlib.crc32(rec) & 0xFFFFFFFF) != ent["crc32"]:
            raise HandoffError(f"crc mismatch for var {name!r}")
        arr = np.load(_io.BytesIO(rec), allow_pickle=False)
        if (str(arr.dtype) != ent["dtype"]
                or list(arr.shape) != list(ent["shape"])):
            raise HandoffError(
                f"var {name!r} decoded as {arr.dtype}{arr.shape}, "
                f"manifest says {ent['dtype']}{tuple(ent['shape'])}")
        arrays[name] = arr
    return arrays, dict(manifest.get("meta", {}))
