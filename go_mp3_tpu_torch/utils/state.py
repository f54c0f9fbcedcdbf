"""Checkpoint serialization: Decoder.checkpoint() dicts <-> bytes.

The reference carries decode state implicitly ({bit reservoir bytes, IMDCT
overlap store, polyphase vVec, byte position} — SURVEY.md §5);
`Decoder.checkpoint()` makes it an explicit dict of plain values. These
helpers give that dict a stable wire format so a decode can be
checkpointed, shipped to another host, and resumed sample-exactly
(`Decoder.checkpoint_bytes()` / `Decoder.resume_bytes()` wrap them).

Format: a 4-byte little-endian JSON-header length, the JSON header (scalar
fields plus per-blob lengths), then the raw blobs (reservoir/buf bytes and
C-order float32 arrays) concatenated.
"""

from __future__ import annotations

import json

import numpy as np

_VERSION = 1


def checkpoint_to_bytes(ck: dict) -> bytes:
    """Serialize a Decoder.checkpoint() dict."""
    kind, store, vvec = ck["dsp"]
    store = np.ascontiguousarray(store)  # f32 device/exact, f64 golden
    vvec = np.ascontiguousarray(vvec)
    blobs = [bytes(ck["buf"]), bytes(ck["reservoir"]),
             store.tobytes(), vvec.tobytes()]
    header = {
        "version": _VERSION,
        "pos": ck["pos"],
        "at_end": bool(ck["at_end"]),
        "backend": ck["backend"],
        "dsp_kind": kind,
        "store_shape": list(store.shape),
        "vvec_shape": list(vvec.shape),
        "dtype": store.dtype.name,
        "blob_lens": [len(b) for b in blobs],
    }
    for key in ("parser_offset", "source_pos", "have_frame"):
        if key in ck:
            header[key] = ck[key]
    hdr = json.dumps(header).encode()
    return len(hdr).to_bytes(4, "little") + hdr + b"".join(blobs)


def checkpoint_from_bytes(data: bytes) -> dict:
    """Parse bytes from checkpoint_to_bytes back into a checkpoint dict."""
    n = int.from_bytes(data[:4], "little")
    header = json.loads(data[4 : 4 + n])
    if header.get("version") != _VERSION:
        raise ValueError(f"unknown checkpoint version {header.get('version')}")
    off = 4 + n
    blobs = []
    for blen in header["blob_lens"]:
        blobs.append(data[off : off + blen])
        off += blen
    buf, reservoir, store_b, vvec_b = blobs
    dt = np.dtype(header["dtype"])
    store = np.frombuffer(store_b, dt).reshape(header["store_shape"])
    vvec = np.frombuffer(vvec_b, dt).reshape(header["vvec_shape"])
    ck: dict = {
        "pos": header["pos"],
        "buf": buf,
        "at_end": header["at_end"],
        "backend": header["backend"],
        "reservoir": reservoir,
        "dsp": (header["dsp_kind"], store.copy(), vvec.copy()),
    }
    for key in ("parser_offset", "source_pos", "have_frame"):
        if key in header:
            ck[key] = header[key]
    return ck
