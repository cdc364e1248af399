"""Workflow messages (§4.1): header + arbitrary, dynamically-sized payload.

This is the paper's answer to NCCL limitation L1/L2 — a message can carry
raw bytes, a single tensor, or a pytree of tensors of shapes unknown to the
receiver in advance; everything needed to decode travels in the message.

Header fields (Figure 3): UUID, proxy timestamp, application id, stage.
"""
from __future__ import annotations

import json
import struct
import time
import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple, Union

import numpy as np

_HDR = struct.Struct("<16sdIIQ")  # uuid, timestamp, app_id, stage, payload_len
HEADER_BYTES = _HDR.size

Payload = Union[bytes, np.ndarray, Dict[str, Any], List[Any], Tuple[Any, ...], str, int, float, None]

_KIND_BYTES = 0
_KIND_TENSOR = 1
_KIND_JSONTREE = 2
_KIND_KVPAGES = 3

_KEEP = object()  # for_stage default: carry this message's payload unchanged


Buf = Union[bytes, bytearray, memoryview]


@dataclass
class KVPages:
    """A prefilled request's KV cache as an ordered page list (§KV-ship,
    docs/disaggregation.md).

    ``pages`` holds the cache tree's leaves in ``jax.tree`` flatten order —
    one page per leaf, each a B=1 slice along that leaf's batch axis.
    ``meta`` is the JSON-safe decode plan riding along (prompt tokens,
    start index, steps, temperature, seed).  The wire form is one gather
    list — header, meta blob, then each page's raw bytes behind a ``<Q>``
    length — so a whole cache ships as ONE ``RdmaFabric.writev`` with no
    Python-side concatenation, and decodes back to zero-copy views over
    the ring slot.
    """

    meta: Dict[str, Any]
    pages: List[np.ndarray] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pages)


def _tensor_view(x: np.ndarray) -> Buf:
    """Zero-copy byte view of a contiguous array (copies only if the input
    was non-contiguous and ascontiguousarray had to materialize it)."""
    if x.size == 0:
        return b""  # memoryview cannot cast a view with zeros in its shape
    return memoryview(np.ascontiguousarray(x)).cast("B")


def _encode_payload_parts(payload: Payload) -> List[Buf]:
    """Self-describing encoding for arbitrary payload types, as a gather
    list of buffer parts.  Tensor bytes stay as memoryviews over the source
    arrays — nothing is concatenated in Python; the fabric's scatter-gather
    ``writev`` copies each part straight into the destination region."""
    if isinstance(payload, np.generic):  # numpy scalar -> 0-d tensor
        payload = np.asarray(payload)
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [struct.pack("<B", _KIND_BYTES), payload]
    if isinstance(payload, np.ndarray):
        meta = json.dumps({"dtype": payload.dtype.str, "shape": payload.shape}).encode()
        return [struct.pack("<BI", _KIND_TENSOR, len(meta)), meta,
                _tensor_view(payload)]
    if isinstance(payload, KVPages):
        pages = [np.asarray(p) for p in payload.pages]
        meta = json.dumps({
            "meta": payload.meta,
            "pages": [{"dtype": p.dtype.str, "shape": list(p.shape)}
                      for p in pages]}).encode()
        parts: List[Buf] = [
            struct.pack("<BII", _KIND_KVPAGES, len(meta), len(pages)), meta]
        for p in pages:
            view = _tensor_view(p)
            parts.append(struct.pack("<Q", len(view)))
            parts.append(view)
        return parts
    # generic pytree: JSON skeleton with tensor leaves hoisted to a blob list
    blobs: List[memoryview] = []

    def hoist(x):
        if isinstance(x, np.generic):
            x = np.asarray(x)
        if isinstance(x, np.ndarray):
            blobs.append(_tensor_view(x))
            return {"__tensor__": len(blobs) - 1,
                    "dtype": x.dtype.str, "shape": list(x.shape)}
        if isinstance(x, dict):
            return {k: hoist(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [hoist(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        raise TypeError(f"unsupported payload leaf {type(x)}")

    skel = json.dumps(hoist(payload)).encode()
    parts: List[Buf] = [struct.pack("<BII", _KIND_JSONTREE, len(skel), len(blobs)), skel]
    for b in blobs:
        parts.append(struct.pack("<Q", len(b)))
        parts.append(b)
    return parts


def _encode_payload(payload: Payload) -> bytes:
    """Blob form of the encoding (one concatenation; legacy path)."""
    return b"".join(_encode_payload_parts(payload))


def _decode_payload(raw: Buf) -> Payload:
    """Decode from any buffer; tensor leaves are zero-copy views into `raw`
    (read-only, exactly like the seed's frombuffer-over-bytes behavior)."""
    mv = memoryview(raw)
    kind = mv[0]
    if kind == _KIND_BYTES:
        return bytes(mv[1:])
    if kind == _KIND_TENSOR:
        (mlen,) = struct.unpack_from("<I", mv, 1)
        meta = json.loads(bytes(mv[5 : 5 + mlen]))
        return np.frombuffer(mv[5 + mlen :], dtype=np.dtype(meta["dtype"])).reshape(
            meta["shape"]
        )
    if kind == _KIND_JSONTREE:
        slen, nblobs = struct.unpack_from("<II", mv, 1)
        off = 9
        skel = json.loads(bytes(mv[off : off + slen]))
        off += slen
        blobs = []
        for _ in range(nblobs):
            (blen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            blobs.append(mv[off : off + blen])
            off += blen

        def lower(x):
            if isinstance(x, dict):
                if "__tensor__" in x:
                    return np.frombuffer(
                        blobs[x["__tensor__"]], dtype=np.dtype(x["dtype"])
                    ).reshape(x["shape"])
                return {k: lower(v) for k, v in x.items()}
            if isinstance(x, list):
                return [lower(v) for v in x]
            return x

        return lower(skel)
    if kind == _KIND_KVPAGES:
        mlen, npages = struct.unpack_from("<II", mv, 1)
        off = 9
        head = json.loads(bytes(mv[off : off + mlen]))
        off += mlen
        pages = []
        for spec in head["pages"]:
            (blen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            pages.append(np.frombuffer(
                mv[off : off + blen],
                dtype=np.dtype(spec["dtype"])).reshape(spec["shape"]))
            off += blen
        return KVPages(meta=head["meta"], pages=pages)
    raise ValueError(f"bad payload kind {kind}")


@dataclass
class WorkflowMessage:
    """A message flowing between workflow instances."""

    uid: bytes  # 16B UUID assigned by the proxy
    timestamp: float  # proxy receive time (latency monitoring)
    app_id: int  # selects the application workflow (routing)
    stage: int  # current stage index
    payload: Payload = None

    @classmethod
    def new(cls, app_id: int, payload: Payload = None, stage: int = 0) -> "WorkflowMessage":
        return cls(
            uid=uuidlib.uuid4().bytes,
            timestamp=time.time(),
            app_id=app_id,
            stage=stage,
            payload=payload,
        )

    @property
    def uid_hex(self) -> str:
        return self.uid.hex()

    def pack_parts(self) -> List[Buf]:
        """Scatter-gather form of ``pack``: the wire header followed by the
        payload's gather list.  No Python-level concatenation — handed to
        ``RingProducer.append`` the parts flow to the ring via one
        ``writev``."""
        body = _encode_payload_parts(self.payload)
        blen = sum(len(p) for p in body)
        return [_HDR.pack(self.uid, self.timestamp, self.app_id, self.stage, blen),
                *body]

    def pack(self) -> bytes:
        return b"".join(self.pack_parts())

    @classmethod
    def unpack(cls, raw: Buf) -> "WorkflowMessage":
        mv = memoryview(raw)
        uid, ts, app_id, stage, plen = _HDR.unpack_from(mv, 0)
        body = mv[HEADER_BYTES : HEADER_BYTES + plen]
        return cls(uid=uid, timestamp=ts, app_id=app_id, stage=stage,
                   payload=_decode_payload(body))

    def next_stage(self, payload: Payload) -> "WorkflowMessage":
        """Derive the message for the next hop, preserving identity fields."""
        return WorkflowMessage(
            uid=self.uid, timestamp=self.timestamp, app_id=self.app_id,
            stage=self.stage + 1, payload=payload,
        )

    def for_stage(self, stage: int, payload: Payload = _KEEP) -> "WorkflowMessage":
        """Per-edge copy for DAG routing: same identity (UID, proxy
        timestamp), explicit target stage index.  Fan-out derives one copy
        per successor edge; a fan-in join derives the assembled message."""
        return WorkflowMessage(
            uid=self.uid, timestamp=self.timestamp, app_id=self.app_id,
            stage=stage,
            payload=self.payload if payload is _KEEP else payload,
        )
