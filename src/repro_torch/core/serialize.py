"""Versioned, checksummed `Program` serialization (DESIGN.md §7).

A compiled program is the expensive artifact of this stack — the serving
roadmap ("compile once, serve millions of requests") needs fleet nodes to
load a precompiled `Program` from disk instead of re-running the compiler.
That only works if a damaged blob can never be executed, so the format is
integrity-first:

    [ magic 8B ][ version u32 ][ header_len u32 ][ header_crc32 u32 ]
    [ header: UTF-8 JSON                                            ]
    [ payload: raw C-order array bytes, concatenated                ]

The JSON header carries the `AccelConfig`, the scalar `ScheduleStats`
fields, and a manifest of every payload array (name, dtype, shape, byte
length, CRC32) plus a whole-payload CRC32 — every byte of the file is
covered by either the header CRC or the payload CRC, so flipping *any*
byte (magic, version, lengths, checksums themselves, header, payload)
surfaces as a `ProgramCorruptionError` at load time, never as a silently
wrong solve.  `load_program` additionally re-validates the decoded
instruction stream structurally (`robust.verify_program`) unless asked
not to.

Not serialized: ``stats.pass_stats`` (per-pass compile telemetry — it
describes the compilation run, not the artifact) — a loaded program
carries ``pass_stats=None``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import zlib

import numpy as np

from .errors import ProgramCorruptionError
from .program import AccelConfig, Program, ScheduleStats

__all__ = [
    "FORMAT_VERSION",
    "MAGIC",
    "save_program",
    "load_program",
    "dumps_program",
    "loads_program",
]

MAGIC = b"SPTRSVPG"
FORMAT_VERSION = 1

_FIXED = struct.Struct("<8sIII")  # magic, version, header_len, header_crc

# payload arrays in fixed order; (attribute, required)
_ARRAYS = (
    ("instr", True),
    ("val_idx", True),
    ("stream", True),
    ("row_lo", False),
    ("row_hi", False),
    ("stream_src", False),  # value provenance (values-only recompile path)
)
_STATS_ARRAYS = (("per_cu_edges", False),)
# ScheduleStats fields that do NOT round-trip as JSON scalars
# (schedule_costs is a nested dict — auto-select evidence, not a scalar;
# the chosen strategy name itself round-trips via the "schedule" field)
_STATS_SKIP = {"per_cu_edges", "pass_stats", "schedule_costs"}


def _corrupt(msg: str, **detail) -> ProgramCorruptionError:
    return ProgramCorruptionError(f"serialized program corrupt: {msg}",
                                  detail=detail)


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def dumps_program(prog: Program) -> bytes:
    """Serialize ``prog`` to a self-verifying byte blob (format above)."""
    manifest = []
    payload = io.BytesIO()
    arrays = [(name, getattr(prog, name), req) for name, req in _ARRAYS]
    arrays += [(name, getattr(prog.stats, name), req)
               for name, req in _STATS_ARRAYS]
    for name, arr, required in arrays:
        if arr is None:
            if required:
                raise ValueError(f"program is missing required array {name!r}")
            continue
        raw = np.ascontiguousarray(arr).tobytes()
        manifest.append({
            "name": name,
            "dtype": np.asarray(arr).dtype.str,
            "shape": list(np.asarray(arr).shape),
            "nbytes": len(raw),
            "crc32": zlib.crc32(raw),
        })
        payload.write(raw)
    payload_bytes = payload.getvalue()

    stats = {
        f.name: _jsonable(getattr(prog.stats, f.name))
        for f in dataclasses.fields(ScheduleStats)
        if f.name not in _STATS_SKIP
    }
    header = {
        "format": "sptrsv-program",
        "version": FORMAT_VERSION,
        "n": int(prog.n),
        "num_slots": int(prog.num_slots),
        "config": {f.name: _jsonable(getattr(prog.config, f.name))
                   for f in dataclasses.fields(AccelConfig)},
        "stats": stats,
        "arrays": manifest,
        "payload_crc32": zlib.crc32(payload_bytes),
    }
    header_bytes = json.dumps(header, sort_keys=True).encode("utf-8")
    fixed = _FIXED.pack(MAGIC, FORMAT_VERSION, len(header_bytes),
                        zlib.crc32(header_bytes))
    return fixed + header_bytes + payload_bytes


def loads_program(data: bytes, *, verify: bool = True) -> Program:
    """Parse a blob from `dumps_program`; every defect raises
    `ProgramCorruptionError` (bad magic/version, truncation, trailing
    bytes, any CRC mismatch, malformed header, manifest/shape drift).

    ``verify=True`` (default) additionally runs the structural validator
    (`robust.verify_program`) on the decoded program.
    """
    if len(data) < _FIXED.size:
        raise _corrupt("truncated fixed header",
                       have=len(data), need=_FIXED.size)
    magic, version, header_len, header_crc = _FIXED.unpack_from(data)
    if magic != MAGIC:
        raise _corrupt(f"bad magic {magic!r}", expected=MAGIC.decode())
    if version != FORMAT_VERSION:
        raise _corrupt(f"unsupported format version {version}",
                       supported=FORMAT_VERSION)
    header_end = _FIXED.size + header_len
    if len(data) < header_end:
        raise _corrupt("truncated header", have=len(data), need=header_end)
    header_bytes = data[_FIXED.size:header_end]
    if zlib.crc32(header_bytes) != header_crc:
        raise _corrupt("header CRC mismatch")
    try:
        header = json.loads(header_bytes.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _corrupt(f"header not valid JSON ({e})") from e

    payload = data[header_end:]
    expected = sum(a["nbytes"] for a in header.get("arrays", ()))
    if len(payload) != expected:
        raise _corrupt("payload length mismatch",
                       have=len(payload), need=expected)
    if zlib.crc32(payload) != header.get("payload_crc32"):
        raise _corrupt("payload CRC mismatch")

    arrays: dict[str, np.ndarray] = {}
    off = 0
    for entry in header["arrays"]:
        raw = payload[off:off + entry["nbytes"]]
        off += entry["nbytes"]
        if zlib.crc32(raw) != entry["crc32"]:
            raise _corrupt(f"array {entry['name']!r} CRC mismatch")
        try:
            arr = np.frombuffer(raw, dtype=np.dtype(entry["dtype"]))
            arrays[entry["name"]] = arr.reshape(entry["shape"]).copy()
        except (TypeError, ValueError) as e:
            raise _corrupt(
                f"array {entry['name']!r} undecodable ({e})") from e

    try:
        config = AccelConfig(**header["config"])
        stats = ScheduleStats(
            **header["stats"],
            per_cu_edges=arrays.pop("per_cu_edges", None),
        )
        prog = Program(
            config=config,
            n=header["n"],
            instr=arrays["instr"],
            val_idx=arrays["val_idx"],
            stream=arrays["stream"],
            stats=stats,
            num_slots=header["num_slots"],
            row_lo=arrays.get("row_lo"),
            row_hi=arrays.get("row_hi"),
            stream_src=arrays.get("stream_src"),
        )
    except (KeyError, TypeError) as e:
        raise _corrupt(f"header schema mismatch ({e})") from e
    if verify:
        from .robust import verify_program  # lazy: robust imports analysis

        verify_program(prog)
    return prog


def save_program(prog: Program, path) -> None:
    """Write ``prog`` to ``path`` in the checksummed format above."""
    blob = dumps_program(prog)
    with open(path, "wb") as f:
        f.write(blob)


def load_program(path, *, verify: bool = True) -> Program:
    """Load a program saved by `save_program`; see `loads_program`."""
    with open(path, "rb") as f:
        data = f.read()
    return loads_program(data, verify=verify)
