"""Framed binary multi-item wire format, the port's own copy of
``tpuserve/frame.py`` (numpy only; the port imports nothing from
``tpuserve``).

``application/x-tpuserve-frame`` is the ingest fast path's wire contract: one
POST carries N exact-wire-size items — uint8 RGB tensors or YUV 4:2:0 planes —
with no per-item npy headers, no base64, no JSON. Layout (all integers
little-endian)::

    +--------+---------+--------+---------+---------+
    | magic  | version | kind   | count   | edge    |   fixed 16-byte header
    | "TPUF" | u16 = 1 | u16    | u32     | u32     |
    +--------+---------+--------+---------+---------+
    | offset[0] ... offset[count]   (count+1 x u64) |   offset table
    +-----------------------------------------------+
    | item 0 bytes | item 1 bytes | ... | item N-1  |   payload region
    +-----------------------------------------------+

Offsets are relative to the start of the payload region (the byte after the
table), strictly ascending, ``offset[0] == 0``, ``offset[count] == len(payload)``.
Every item is exactly ``item_nbytes(kind, edge)`` long:

- ``KIND_RGB8`` (1): ``(edge, edge, 3)`` uint8, C-order — 3 B/px.
- ``KIND_YUV420`` (2): full-res Y plane ``(edge, edge)`` followed by the two
  2x2-subsampled chroma planes ``(edge/2, edge/2)`` — 1.5 B/px, what a
  baseline JPEG stores and what ``preproc.device_prepare_images_yuv420``
  consumes.

Parsing is **zero-copy**: ``parse_frame`` returns ``np.frombuffer`` views
over a ``memoryview`` of the request body. The views are read-only and keep
the body alive; the single copy happens when ``ServingModel.assemble_into``
writes them into the batcher's pinned assembly buffer.

Every malformed-frame condition raises :class:`FrameError` (a ``ValueError``)
with a ``frame:``-prefixed message; the HTTP layer answers it with a 400 and
ticks ``frame_errors_total{model=}``.
"""

from __future__ import annotations

import struct

import numpy as np

CONTENT_TYPE = "application/x-tpuserve-frame"

MAGIC = b"TPUF"
VERSION = 1
KIND_RGB8 = 1
KIND_YUV420 = 2
# Stream-only: a self-delimiting JSON event frame. Never valid in a request
# body (parse_frame rejects the kind); it lets a chunked binary *response*
# stream interleave progress/done/error events between image frames.
# ``count`` carries the payload byte length, ``edge`` is 0, and there is no
# offset table — header + payload, nothing else.
KIND_EVENT = 3
KIND_NAMES = {KIND_RGB8: "rgb8", KIND_YUV420: "yuv420"}
KIND_BY_WIRE_FORMAT = {"rgb8": KIND_RGB8, "yuv420": KIND_YUV420}

# magic, version, kind, count, edge.
_HEADER = struct.Struct("<4sHHII")
HEADER_SIZE = _HEADER.size  # 16


class FrameError(ValueError):
    """A malformed ``application/x-tpuserve-frame`` body (-> HTTP 400)."""


def item_nbytes(kind: int, edge: int) -> int:
    """Exact payload bytes of ONE item: 3 B/px rgb8, 1.5 B/px yuv420."""
    if kind == KIND_RGB8:
        return 3 * edge * edge
    if kind == KIND_YUV420:
        return edge * edge + 2 * (edge // 2) * (edge // 2)
    raise FrameError(f"frame: unknown item kind {kind}")


def frame_nbytes(kind: int, edge: int, count: int) -> int:
    """Total body bytes of a frame of ``count`` items (header + table +
    payload)."""
    return HEADER_SIZE + 8 * (count + 1) + count * item_nbytes(kind, edge)


def encode_frame(items: list, kind: int, edge: int) -> bytes:
    """Build a frame body from decoded items (the client side).

    ``items`` are ``(edge, edge, 3)`` uint8 arrays for ``KIND_RGB8`` or
    ``(y, u, v)`` uint8 plane tuples for ``KIND_YUV420`` (the
    ``preproc.rgb_to_yuv420`` shape contract)."""
    if not items:
        raise FrameError("frame: cannot encode an empty frame")
    size = item_nbytes(kind, edge)
    chunks: list[bytes] = []
    offsets = [0]
    for it in items:
        if kind == KIND_YUV420:
            raw = b"".join(np.ascontiguousarray(p, dtype=np.uint8).tobytes()
                           for p in it)
        else:
            raw = np.ascontiguousarray(it, dtype=np.uint8).tobytes()
        if len(raw) != size:
            raise FrameError(
                f"frame: item has {len(raw)} bytes, expected {size} "
                f"({KIND_NAMES[kind]}@{edge})")
        chunks.append(raw)
        offsets.append(offsets[-1] + size)
    header = _HEADER.pack(MAGIC, VERSION, kind, len(items), edge)
    table = np.asarray(offsets, dtype="<u8").tobytes()
    return b"".join([header, table, *chunks])


def encode_stream_event(payload: bytes) -> bytes:
    """One self-delimiting ``KIND_EVENT`` frame for a binary response
    stream: 16-byte header (count = payload byte length, edge = 0) followed
    directly by the JSON payload. Pairs with :class:`StreamFrameReader`."""
    return _HEADER.pack(MAGIC, VERSION, KIND_EVENT, len(payload), 0) + payload


class StreamFrameReader:
    """Incremental decoder for a chunked binary response stream (the client
    side). ``feed`` accepts arbitrary transport chunk splits and returns the
    frames completed so far as ``(kind, payload)`` tuples — for
    ``KIND_EVENT`` the payload is the raw JSON bytes; for image kinds it is
    the COMPLETE frame body (header included), ready for
    :func:`parse_frame`."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list:
        self._buf += chunk
        frames: list = []
        while len(self._buf) >= HEADER_SIZE:
            magic, version, kind, count, edge = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise FrameError(f"frame: bad stream magic {bytes(magic)!r}")
            if version != VERSION:
                raise FrameError(
                    f"frame: unsupported stream frame version {version}")
            if kind == KIND_EVENT:
                total = HEADER_SIZE + count
            elif kind in KIND_NAMES:
                total = frame_nbytes(kind, edge, count)
            else:
                raise FrameError(f"frame: unknown stream frame kind {kind}")
            if len(self._buf) < total:
                break
            body = bytes(self._buf[:total])
            del self._buf[:total]
            frames.append((kind, body[HEADER_SIZE:] if kind == KIND_EVENT
                           else body))
        return frames

    @property
    def pending(self) -> int:
        """Buffered bytes of a not-yet-complete frame (a torn stream ends
        with pending > 0 or a missing terminal event — never silently)."""
        return len(self._buf)


def parse_frame(body: bytes, *, kind: int, edge: int, max_items: int) -> list:
    """Parse a frame body into zero-copy per-item views (the server side).

    Returns ``(edge, edge, 3)`` uint8 views for ``KIND_RGB8`` or
    ``(y, u, v)`` plane-view tuples for ``KIND_YUV420``, each an
    ``np.frombuffer`` slice of ``body``. ``kind`` is what the model serves
    (its ``wire_format``): a client frame of another kind is a 400, not a
    silent server-side convert.

    Raises :class:`FrameError` on every malformed condition: truncated
    header or offset table, bad magic/version/kind, kind mismatch, edge
    mismatch, zero or over-``max_items`` count, non-ascending offsets,
    zero-length or wrong-length items, and a table pointing past the end
    of the body.
    """
    mv = memoryview(body)
    if len(mv) < HEADER_SIZE:
        raise FrameError(
            f"frame: truncated header ({len(mv)} bytes, need {HEADER_SIZE})")
    magic, version, fkind, count, fedge = _HEADER.unpack_from(mv)
    if magic != MAGIC:
        raise FrameError(f"frame: bad magic {bytes(magic)!r}")
    if version != VERSION:
        raise FrameError(
            f"frame: unsupported version {version} (this server speaks "
            f"{VERSION})")
    if fkind not in KIND_NAMES:
        raise FrameError(f"frame: unknown item kind {fkind}")
    if fkind != kind:
        raise FrameError(
            f"frame: item kind {KIND_NAMES[fkind]} does not match the "
            f"model's wire_format {KIND_NAMES[kind]}")
    if count < 1:
        raise FrameError("frame: item count must be >= 1")
    if count > max_items:
        raise FrameError(
            f"frame: {count} items exceeds the per-request limit "
            f"({max_items})")
    if fedge != edge:
        raise FrameError(
            f"frame: edge {fedge} does not match the model's wire_size "
            f"{edge} (clients resize before framing)")
    table_end = HEADER_SIZE + 8 * (count + 1)
    if len(mv) < table_end:
        raise FrameError(
            f"frame: truncated offset table ({len(mv)} bytes, need "
            f"{table_end})")
    offsets = np.frombuffer(mv[HEADER_SIZE:table_end], dtype="<u8")
    payload = mv[table_end:]
    size = item_nbytes(kind, edge)
    if int(offsets[0]) != 0:
        raise FrameError(f"frame: first offset must be 0, got {offsets[0]}")
    if int(offsets[-1]) != len(payload):
        raise FrameError(
            f"frame: offset table ends at {int(offsets[-1])} but the "
            f"payload region is {len(payload)} bytes")
    items: list = []
    half = edge // 2
    y_n, c_n = edge * edge, half * half
    for i in range(count):
        a, b = int(offsets[i]), int(offsets[i + 1])
        if b - a != size:
            raise FrameError(
                f"frame: item {i} spans {b - a} bytes, expected {size} "
                f"({KIND_NAMES[kind]}@{edge}; zero-length and partial "
                "items are rejected)")
        raw = np.frombuffer(payload[a:b], dtype=np.uint8)
        if kind == KIND_RGB8:
            items.append(raw.reshape(edge, edge, 3))
        else:
            items.append((
                raw[:y_n].reshape(edge, edge),
                raw[y_n:y_n + c_n].reshape(half, half),
                raw[y_n + c_n:].reshape(half, half),
            ))
    return items
