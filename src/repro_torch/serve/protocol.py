"""Wire protocol for the serving fleet: length-prefixed frames.

One frame = a fixed 14-byte header (``N3HF`` magic, version, kind
byte, header length, payload length) + a canonical-JSON header dict +
an opaque payload. The JSON half carries control fields (sequence
numbers, slot indices, channel names); the payload carries bulk bytes
(``N3HPROG1`` program sections shipped byte-for-byte out of the
``ProgramCache`` images, packed weight arrays, activation tiles for
the ``*.xdev`` channel hand-shake).

The same frame codec backs both transports: the blocking
:class:`FrameStream` used by worker processes/threads over a socket,
and the ``asyncio`` reader/writer helpers the :class:`fleet.FleetServer`
event loop uses. Array payloads use :func:`pack_arrays` — a
deterministic little-endian packing (sorted names, C-order bytes) so
the bytes a worker binds are a pure function of the arrays, which is
what the fleet's bit-exactness gate transports over the wire.
"""
from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"N3HF"
VERSION = 1

_HDR = struct.Struct("<4sBBII")

#: frame kinds, u8 on the wire. Control plane: hello/ready/ping/pong/
#: error/shutdown. Data plane: load_program & bind_arrays (resident
#: decode sessions), load_section (one bundle device section),
#: step/reset_slot/result (slot-batched decode), run_layer/chan (the
#: cross-device hand-shake for bundle programs).
KINDS = (
    "hello", "ready", "ping", "pong", "error", "shutdown",
    "load_program", "load_section", "bind_arrays",
    "step", "reset_slot", "result", "run_layer", "chan",
)
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}


class ProtocolError(RuntimeError):
    """Malformed frame / unknown kind / bad magic on the fleet wire."""


def encode_frame(kind: str, header: dict | None = None,
                 payload: bytes = b"") -> bytes:
    """Render one frame to bytes (canonical JSON header, so identical
    (kind, header, payload) always yields identical bytes)."""
    if kind not in _KIND_CODE:
        raise ProtocolError(f"unknown frame kind {kind!r}")
    blob = json.dumps(header or {}, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return _HDR.pack(MAGIC, VERSION, _KIND_CODE[kind], len(blob),
                     len(payload)) + blob + bytes(payload)


def decode_frame(data: bytes) -> tuple[str, dict, bytes]:
    """Parse one complete frame; raises :class:`ProtocolError` on any
    structural defect (bad magic/version/kind, truncation, trailing
    bytes)."""
    if len(data) < _HDR.size:
        raise ProtocolError(f"short frame ({len(data)} bytes)")
    magic, ver, code, hlen, plen = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise ProtocolError(f"unsupported protocol version {ver}")
    if code >= len(KINDS):
        raise ProtocolError(f"unknown kind code {code}")
    if len(data) != _HDR.size + hlen + plen:
        raise ProtocolError(
            f"frame length mismatch: header says {_HDR.size + hlen + plen},"
            f" got {len(data)}")
    try:
        header = json.loads(data[_HDR.size:_HDR.size + hlen])
    except json.JSONDecodeError as e:
        raise ProtocolError(f"bad frame header JSON: {e}") from e
    return KINDS[code], header, data[_HDR.size + hlen:]


# -- blocking transport (worker side) ------------------------------------


class FrameStream:
    """Blocking frame codec over a connected socket."""

    def __init__(self, sock):
        self.sock = sock

    def send(self, kind: str, header: dict | None = None,
             payload: bytes = b"") -> None:
        self.sock.sendall(encode_frame(kind, header, payload))

    def recv(self) -> tuple[str, dict, bytes]:
        """Read exactly one frame; raises :class:`ProtocolError` on a
        closed or corrupt stream."""
        head = self._read_exact(_HDR.size)
        magic, ver, code, hlen, plen = _HDR.unpack_from(head)
        if magic != MAGIC:
            raise ProtocolError(f"bad magic {magic!r}")
        body = self._read_exact(hlen + plen)
        return decode_frame(head + body)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self.sock.recv(min(n - got, 1 << 20))
            if not chunk:
                raise ProtocolError("stream closed mid-frame")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)


# -- asyncio transport (server side) -------------------------------------


async def read_frame(reader) -> tuple[str, dict, bytes]:
    """Read one frame from an ``asyncio.StreamReader``; raises
    :class:`ProtocolError` at EOF / corruption."""
    import asyncio

    try:
        head = await reader.readexactly(_HDR.size)
        magic, ver, code, hlen, plen = _HDR.unpack_from(head)
        if magic != MAGIC:
            raise ProtocolError(f"bad magic {magic!r}")
        body = await reader.readexactly(hlen + plen)
    except (asyncio.IncompleteReadError, ConnectionError) as e:
        raise ProtocolError(f"stream closed mid-frame: {e!r}") from e
    return decode_frame(head + body)


def write_frame(writer, kind: str, header: dict | None = None,
                payload: bytes = b"") -> None:
    """Queue one frame on an ``asyncio.StreamWriter`` (caller drains)."""
    writer.write(encode_frame(kind, header, payload))


# -- array payloads -------------------------------------------------------


def pack_arrays(arrays: dict) -> bytes:
    """Pack a name->ndarray dict into deterministic bytes: sorted
    names, little-endian dtype descriptors, C-order data. The inverse
    of :func:`unpack_arrays` (exact round-trip incl. dtypes/shapes)."""
    parts = [struct.pack("<I", len(arrays))]
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        nb = name.encode("utf-8")
        db = arr.dtype.str.encode("ascii")
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<B", len(db)))
        parts.append(db)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}I", *arr.shape)
                     if arr.ndim else b"")
        raw = arr.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def unpack_arrays(data: bytes) -> dict:
    """Inverse of :func:`pack_arrays`."""
    try:
        (count,) = struct.unpack_from("<I", data, 0)
        pos = 4
        out = {}
        for _ in range(count):
            (nlen,) = struct.unpack_from("<H", data, pos)
            pos += 2
            name = data[pos:pos + nlen].decode("utf-8")
            pos += nlen
            (dlen,) = struct.unpack_from("<B", data, pos)
            pos += 1
            dtype = np.dtype(data[pos:pos + dlen].decode("ascii"))
            pos += dlen
            (ndim,) = struct.unpack_from("<B", data, pos)
            pos += 1
            shape = struct.unpack_from(f"<{ndim}I", data, pos)
            pos += 4 * ndim
            (nbytes,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            out[name] = np.frombuffer(
                data[pos:pos + nbytes], dtype).reshape(shape).copy()
            pos += nbytes
        if pos != len(data):
            raise ProtocolError(
                f"trailing bytes in array payload ({len(data) - pos})")
        return out
    except (struct.error, UnicodeDecodeError, TypeError,
            ValueError) as e:
        if isinstance(e, ProtocolError):
            raise
        raise ProtocolError(f"corrupt array payload: {e!r}") from e


# -- bundle distribution --------------------------------------------------


def split_bundle_image(image: bytes) -> tuple[dict, list[bytes]]:
    """Split an ``N3HBUND1`` image into its JSON meta dict and the
    per-device ``N3HPROG1`` sections *byte-for-byte* (slices of the
    original buffer, no re-serialization) — what the fleet server
    ships each worker from the ``ProgramCache``."""
    from repro_torch.compiler.asm import MAGIC_BUNDLE

    if image[:8] != MAGIC_BUNDLE:
        raise ProtocolError("not an N3HBUND1 image")
    try:
        (meta_len,) = struct.unpack_from("<I", image, 8)
        pos = 12
        meta = json.loads(image[pos:pos + meta_len].decode("utf-8"))
        pos += meta_len
        (n_devices,) = struct.unpack_from("<I", image, pos)
        pos += 4
        sections = []
        for _ in range(n_devices):
            (plen,) = struct.unpack_from("<I", image, pos)
            pos += 4
            sections.append(bytes(image[pos:pos + plen]))
            pos += plen
        if pos != len(image):
            raise ProtocolError(
                f"trailing bytes in bundle image ({len(image) - pos})")
    except (struct.error, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProtocolError(f"corrupt N3HBUND1 image: {e!r}") from e
    return meta, sections
