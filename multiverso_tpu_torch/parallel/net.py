"""Binary wire protocol for the host-side DCN services.

Port of ``multiverso_tpu/parallel/net.py`` (host only: numpy and sockets).
The serving plane speaks it; the PS table service on top of it waits
(ROADMAP A7).

Parity with the reference's single-buffer message framing
(``mpi_net.h:289-317``: header ints + size-prefixed blobs + terminator):
a fixed header {type, table_id, msg_id, src, n_blobs} followed by
length-prefixed numpy blobs (dtype tag + shape + raw bytes), over TCP.

This is deliberately a *host* protocol: it carries request traffic between
processes. Traffic between cards never touches it.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.core.actor import Message

_HEADER = struct.Struct("<iiqii")   # type, table_id, msg_id, src, n_blobs
_BLOB_HEADER = struct.Struct("<16sI")  # dtype string, ndim
_MAGIC = struct.Struct("<I")
_MAGIC_VALUE = 0x4D565450  # "MVTP"

# Decode sanity bounds: a malformed (or hostile) frame must fail fast as
# an IOError, not drive unbounded buffering or a numpy dtype crash.
_MAX_BLOBS = 4096
_MAX_NDIM = 16
_MAX_BLOB_BYTES = 1 << 33   # 8 GB per blob — generous for shard traffic


def _blob_dtype(tag: bytes) -> np.dtype:
    try:
        return np.dtype(tag.rstrip(b"\0").decode())
    except (TypeError, ValueError, UnicodeDecodeError) as e:
        raise IOError(f"bad blob dtype tag {tag!r}") from e


def _pack_blob(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dtype_tag = arr.dtype.str.encode().ljust(16, b"\0")
    parts = [_BLOB_HEADER.pack(dtype_tag, arr.ndim)]
    parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape)
                 if arr.ndim else b"")
    raw = arr.tobytes()
    parts.append(struct.pack("<q", len(raw)))
    parts.append(raw)
    return b"".join(parts)


def pack_message(msg: Message) -> bytes:
    blobs = [np.asarray(b) for b in msg.data]
    parts = [_MAGIC.pack(_MAGIC_VALUE),
             _HEADER.pack(msg.type, msg.table_id, msg.msg_id, msg.src,
                          len(blobs))]
    parts.extend(_pack_blob(b) for b in blobs)
    return b"".join(parts)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        # The read deadline is the CALLER's: clients create the socket
        # with create_connection(timeout=...) (which persists as the
        # socket timeout), and the server side reads through its
        # selector loop, never this helper.
        # graftlint: disable=blocking-call-no-timeout
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def send_message(sock: socket.socket, msg: Message) -> None:
    sock.sendall(pack_message(msg))


def parse_frame(buf) -> Tuple[Optional[Message], int]:
    """Incremental decode for selector-driven servers: returns
    ``(message, bytes_consumed)`` or ``(None, 0)`` when the buffer does not
    yet hold one complete frame. Blob payloads are copied out so the caller
    may immediately compact its receive buffer."""
    n = len(buf)
    if n < _MAGIC.size + _HEADER.size:
        return None, 0
    (value,) = _MAGIC.unpack_from(buf, 0)
    if value != _MAGIC_VALUE:
        raise IOError("bad frame magic")
    off = _MAGIC.size
    mtype, table_id, msg_id, src, n_blobs = _HEADER.unpack_from(buf, off)
    off += _HEADER.size
    if not 0 <= n_blobs <= _MAX_BLOBS:
        raise IOError(f"bad blob count {n_blobs}")
    data: List[np.ndarray] = []
    for _ in range(n_blobs):
        if n < off + _BLOB_HEADER.size:
            return None, 0
        dtype_tag, ndim = _BLOB_HEADER.unpack_from(buf, off)
        off += _BLOB_HEADER.size
        if ndim > _MAX_NDIM:
            raise IOError(f"bad blob ndim {ndim}")
        if n < off + 8 * ndim + 8:
            return None, 0
        shape: Tuple[int, ...] = ()
        if ndim:
            shape = struct.unpack_from(f"<{ndim}q", buf, off)
            off += 8 * ndim
        (nbytes,) = struct.unpack_from("<q", buf, off)
        off += 8
        if not 0 <= nbytes <= _MAX_BLOB_BYTES:
            raise IOError(f"bad blob size {nbytes}")
        if n < off + nbytes:
            return None, 0
        arr = np.frombuffer(bytes(buf[off:off + nbytes]),
                            dtype=_blob_dtype(dtype_tag))
        off += nbytes
        try:
            data.append(arr.reshape(shape))
        except (TypeError, ValueError) as e:
            raise IOError(f"blob shape {shape} does not match payload "
                          f"({nbytes} bytes)") from e
    return Message(src=src, type=mtype, table_id=table_id, msg_id=msg_id,
                   data=data), off


# ---------------------------------------------------------------------------
# Serving-plane payload codec (multiverso_tpu_torch/serving). SERVE_REPLY
# values ride the same length-prefixed blob framing; the marker blob carries
# the wire dtype + logical shape so the reply leg can opt into bf16 truncation
# (-serve_wire_dtype=bf16: half the reply bytes at bfloat16 read precision)
# without the client guessing. Non-float payloads (token ids) always go raw.
# ---------------------------------------------------------------------------
SERVE_WIRE_RAW = 0
SERVE_WIRE_BF16 = 1


# The bfloat16 bit codec of ``multiverso_tpu/utils/quantization.py``.
def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit pattern as uint16, round-to-nearest-even
    (the TPU-native 16-bit format; numpy has no bf16 dtype, so the wire
    carries the raw upper halves). NaNs map to quiet NaN — the rounding
    bias would otherwise turn them into inf (low payload) or wrap to 0
    (negative NaN), silently masking a diverged gradient."""
    b = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    out = (rounded >> np.uint32(16)).astype(np.uint16)
    nan = ((b & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) \
        & ((b & np.uint32(0x007FFFFF)) != 0)
    if nan.any():
        sign = (b[nan] >> np.uint32(16)).astype(np.uint16) \
            & np.uint16(0x8000)
        out[nan] = sign | np.uint16(0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit pattern -> float32 (exact)."""
    return (np.ascontiguousarray(bits, dtype=np.uint16)
            .astype(np.uint32) << np.uint32(16)).view(np.float32)


def pack_serve_payload(arr: np.ndarray, wire_dtype: str = "f32"
                       ) -> List[np.ndarray]:
    """Value array -> [marker, blob]. ``wire_dtype`` in {"f32", "bf16"};
    bf16 applies only to float32 payloads (ids/counts must not truncate)."""
    arr = np.ascontiguousarray(arr)
    marker = np.asarray([SERVE_WIRE_RAW, arr.ndim, *arr.shape],
                        dtype=np.int64)
    if wire_dtype == "bf16" and arr.dtype == np.float32:
        marker[0] = SERVE_WIRE_BF16
        return [marker, f32_to_bf16_bits(arr)]
    return [marker, arr]


def unpack_serve_payload(blobs: List[np.ndarray]) -> np.ndarray:
    marker = blobs[0]
    mode, ndim = int(marker[0]), int(marker[1])
    shape = tuple(int(d) for d in marker[2:2 + ndim])
    if mode == SERVE_WIRE_RAW:
        return blobs[1].reshape(shape)
    if mode == SERVE_WIRE_BF16:
        return bf16_bits_to_f32(blobs[1]).reshape(shape)
    raise IOError(f"unknown serve payload mode {mode}")


# ---------------------------------------------------------------------------
# Trace-context codec (multiverso_tpu_torch/telemetry/context.py). A request's
# distributed trace identity rides the same framing as one extra uint64[5]
# blob on Serve_Request ([trace_hi, trace_lo, span, parent, flags]); an
# absent or malformed blob simply means "no context" — tracing must never
# fail the request it annotates, and peers without the blob interoperate.
# ---------------------------------------------------------------------------
def pack_trace_ctx(ctx) -> np.ndarray:
    """TraceContext -> uint64[5] wire blob."""
    from multiverso_tpu_torch.telemetry.context import to_wire
    return to_wire(ctx)


def unpack_trace_ctx(blob):
    """uint64[5] wire blob -> TraceContext (None on anything malformed)."""
    from multiverso_tpu_torch.telemetry.context import from_wire
    return from_wire(blob)


# ---------------------------------------------------------------------------
# Fleet control-plane payload codec (multiverso_tpu/fleet). Membership and
# routing-table exchange is low-rate structured control traffic — it rides
# the same length-prefixed blob framing as everything else, as one uint8
# blob of canonical JSON. Data-path payloads never use this (they stay raw
# arrays); a malformed control blob decodes to an IOError like any other
# bad frame, never an exception escaping into a reader loop.
# ---------------------------------------------------------------------------
_MAX_JSON_BYTES = 1 << 22   # 4 MB of control JSON is already absurd


def pack_json_blob(obj) -> np.ndarray:
    """Control dict/list -> one uint8 blob for Message.data."""
    import json
    raw = json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()
    if len(raw) > _MAX_JSON_BYTES:
        raise IOError(f"control payload too large ({len(raw)} bytes)")
    return np.frombuffer(raw, dtype=np.uint8)


def unpack_json_blob(blob: np.ndarray):
    """Inverse of :func:`pack_json_blob`; raises IOError on garbage."""
    import json
    raw = np.asarray(blob, dtype=np.uint8).tobytes()
    if len(raw) > _MAX_JSON_BYTES:
        raise IOError(f"control payload too large ({len(raw)} bytes)")
    try:
        return json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise IOError(f"bad control payload: {e}") from e


def recv_message(sock: socket.socket) -> Optional[Message]:
    """Blocking read of one framed message; None on clean EOF."""
    magic = _recv_exact(sock, _MAGIC.size)
    if magic is None:
        return None
    (value,) = _MAGIC.unpack(magic)
    if value != _MAGIC_VALUE:
        raise IOError("bad frame magic")
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    mtype, table_id, msg_id, src, n_blobs = _HEADER.unpack(header)
    if not 0 <= n_blobs <= _MAX_BLOBS:
        raise IOError(f"bad blob count {n_blobs}")
    data: List[np.ndarray] = []
    for _ in range(n_blobs):
        bh = _recv_exact(sock, _BLOB_HEADER.size)
        if bh is None:
            return None
        dtype_tag, ndim = _BLOB_HEADER.unpack(bh)
        if ndim > _MAX_NDIM:
            raise IOError(f"bad blob ndim {ndim}")
        shape: Tuple[int, ...] = ()
        if ndim:
            dims = _recv_exact(sock, 8 * ndim)
            if dims is None:
                return None
            shape = struct.unpack(f"<{ndim}q", dims)
        (nbytes,) = struct.unpack("<q", _recv_exact(sock, 8))
        if not 0 <= nbytes <= _MAX_BLOB_BYTES:
            raise IOError(f"bad blob size {nbytes}")
        raw = _recv_exact(sock, nbytes)
        if raw is None:
            return None
        arr = np.frombuffer(raw, dtype=_blob_dtype(dtype_tag))
        try:
            data.append(arr.reshape(shape))
        except (TypeError, ValueError) as e:
            raise IOError(f"blob shape {shape} does not match payload "
                          f"({nbytes} bytes)") from e
    return Message(src=src, type=mtype, table_id=table_id, msg_id=msg_id,
                   data=data)
