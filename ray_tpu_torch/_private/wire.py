"""Binary fast-path wire format for compiled-DAG channels.

The compiled dataplane's hot loop moves *small* values (ints, strs,
small tuples/dicts, numpy arrays) between resident op loops thousands
of times per second.  Pickling each one costs ~10 us and an intermediate
bytes object per hop; this module replaces that with a fixed two-byte
header and raw little-endian encodings written **directly into the
destination mapping** (the seqlock ring or a socket scratch buffer) —
zero pickling and zero intermediate copies on the fast path.  Anything
the fast path can't express falls back to the existing pickle-5
serialization layer, embedded verbatim after the header.

Layout: ``[u8 tag][u8 type_code][payload]``.  Container elements recurse
as ``[u8 type_code][payload]`` (no tag byte).  The ``tag`` is the same
namespace as ``serialization.TAG_*`` (NORMAL / ERROR), so errors flow
through channels exactly like results.

Trace trailer: a frame written from a traced context sets the tag
byte's high bit (``TRACE_FLAG``) and carries a fixed 33-byte trailer
between the tag byte and the type code — ``[u8 tag|0x80]``
``[16s raw trace id][8s parent span id][u8 flags][f64 write ts]``
``[u8 type_code][payload]`` — so trace identity crosses ring, socket,
and fan-out hops in-band (Dapper-style context propagation, per-frame).
Untraced frames pay zero bytes and exactly one ``is None`` test on the
write path and one bit test on the read path.  ``decode`` masks the
flag and skips the trailer, so legacy readers stay correct;
``decode_traced`` surfaces it.

Port of ``ray_tpu/_private/wire.py``: the same type codes and the same
bytes for every fast-path value.  Two differences.  A ``torch.Tensor``
(the port's counterpart of ``jax.Array``) takes the ``PICKLE`` fallback,
whose pickler moves a card tensor to the host, so a tensor reads back
over a channel exactly as it does through ``get``: a CPU tensor with its
dtype, bf16 included.  And a numpy array whose dtype the buffer protocol
refuses (``datetime64``, ml_dtypes' bfloat16) also takes the fallback,
where the reference's ``memoryview(arr).cast("B")`` raises a
``ValueError`` that channel writers read as "does not fit".  The module
never imports torch: the serve proxy decodes every token frame.

Capacity errors surface as the encoder's ``struct.error``/``ValueError``
/``IndexError`` (writes past the destination view fail — which of the
three depends on whether a struct field, a slice, or a single type-code
byte hit the boundary); channel callers catch all three and translate
into their typed capacity error.
"""

from __future__ import annotations

import struct
import sys
from typing import Any, Tuple

from ray_tpu_torch._private import serialization

# Type codes (second byte of every encoded value).
NONE = 0
TRUE = 1
FALSE = 2
I64 = 3
BIGINT = 4
F64 = 5
BYTES = 6
STR = 7
TUPLE = 8
LIST = 9
DICT = 10
NDARRAY = 11
PICKLE = 12

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# Trace trailer (see module docstring).  The tag byte's high bit marks
# its presence; real tags live in the low 7 bits (serialization.TAG_*
# values are single digits).
TRACE_FLAG = 0x80
TAG_MASK = 0x7F
_TRACE = struct.Struct("<16s8sBd")  # raw trace id, parent span id, flags, write ts
TRACE_LEN = _TRACE.size  # 33

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# Fast-path bounds: bigger containers fall back to pickle (one blob beats
# thousands of per-element dispatches there anyway).
MAX_ELEMS = 64
MAX_DICT = 1024
MAX_DEPTH = 4


class WireFormatError(ValueError):
    """A buffer handed to ``decode`` is not a well-formed wire encoding
    (truncated, bit-flipped, or unknown type code).  Decoding NEVER
    returns a partial/garbage value and never hangs: every malformed
    input surfaces as this one typed error, so channel readers can
    translate it into their corruption error instead of delivering
    wrong data."""


class _Unencodable(Exception):
    """Internal signal: this value needs the pickle fallback."""


def _enc(dest: memoryview, off: int, v: Any, depth: int) -> int:
    t = type(v)
    if v is None:
        dest[off] = NONE
        return off + 1
    if v is True:
        dest[off] = TRUE
        return off + 1
    if v is False:
        dest[off] = FALSE
        return off + 1
    if t is int:
        if _I64_MIN <= v <= _I64_MAX:
            dest[off] = I64
            _I64.pack_into(dest, off + 1, v)
            return off + 9
        n = (v.bit_length() + 8) // 8
        raw = v.to_bytes(n, "little", signed=True)
        dest[off] = BIGINT
        _U32.pack_into(dest, off + 1, n)
        dest[off + 5 : off + 5 + n] = raw
        return off + 5 + n
    if t is float:
        dest[off] = F64
        _F64.pack_into(dest, off + 1, v)
        return off + 9
    if t is bytes:
        dest[off] = BYTES
        _U32.pack_into(dest, off + 1, len(v))
        end = off + 5 + len(v)
        dest[off + 5 : end] = v
        return end
    if t is str:
        raw = v.encode("utf-8")
        dest[off] = STR
        _U32.pack_into(dest, off + 1, len(raw))
        end = off + 5 + len(raw)
        dest[off + 5 : end] = raw
        return end
    if t is tuple or t is list:
        if len(v) > MAX_ELEMS or depth >= MAX_DEPTH:
            raise _Unencodable
        dest[off] = TUPLE if t is tuple else LIST
        dest[off + 1] = len(v)
        off += 2
        for item in v:
            off = _enc(dest, off, item, depth + 1)
        return off
    if t is dict:
        if len(v) > MAX_DICT or depth >= MAX_DEPTH:
            raise _Unencodable
        dest[off] = DICT
        _U32.pack_into(dest, off + 1, len(v))
        off += 5
        for k, item in v.items():
            off = _enc(dest, off, k, depth + 1)
            off = _enc(dest, off, item, depth + 1)
        return off
    np = sys.modules.get("numpy")
    if np is not None and t is np.ndarray:
        return _enc_array(dest, off, v, np)
    # Anything else, a torch.Tensor included, takes the pickle fallback.
    raise _Unencodable


def _enc_array(dest: memoryview, off: int, arr, np) -> int:
    dt = arr.dtype
    if dt.hasobject or arr.ndim > 16:
        raise _Unencodable
    try:
        memoryview(arr)
    except (TypeError, ValueError):
        # a dtype the buffer protocol refuses: pickle carries it
        raise _Unencodable from None
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    ds = dt.str.encode("ascii")
    dest[off] = NDARRAY
    dest[off + 1] = len(ds)
    off += 2
    dest[off : off + len(ds)] = ds
    off += len(ds)
    dest[off] = arr.ndim
    off += 1
    for dim in arr.shape:
        _U64.pack_into(dest, off, dim)
        off += 8
    nb = arr.nbytes
    _U64.pack_into(dest, off, nb)
    off += 8
    if arr.ndim == 0 or 0 in arr.shape:
        # 0-d / zero-size views can't cast; both are tiny — copy is free
        dest[off : off + nb] = arr.tobytes()
    else:
        dest[off : off + nb] = memoryview(arr).cast("B")
    return off + nb


def encode_into(dest: memoryview, value: Any, tag: int = 0,
                trace: Any = None) -> int:
    """Encode ``value`` directly into ``dest``; returns bytes written.

    ``trace`` (optional) is ``(trace_id_hex, parent_span_id_hex, flags,
    write_ts)``: when present the frame carries the 33-byte trace
    trailer and the tag byte's high bit is set.

    Raises ``struct.error``/``ValueError``/``IndexError`` when the
    destination is too small (channel callers catch all three and
    translate to their typed capacity error).
    """
    if trace is None:
        dest[0] = tag
        body = 1
    else:
        dest[0] = tag | TRACE_FLAG
        _TRACE.pack_into(
            dest, 1,
            bytes.fromhex(trace[0]), bytes.fromhex(trace[1]),
            trace[2], trace[3],
        )
        body = 1 + TRACE_LEN
    try:
        return _enc(dest, body, value, 0)
    except _Unencodable:
        meta, buffers = serialization.serialize(value, tag)
        need = body + 1 + serialization.total_size(meta, buffers)
        if need > len(dest):
            raise ValueError(
                f"serialized value of {need} bytes exceeds buffer of {len(dest)}"
            )
        dest[body] = PICKLE
        serialization.write_into(dest[body + 1 :], meta, buffers)
        return need


def _size_hint(v: Any, np) -> int:
    """Bytes a value's arrays and strings will take in a frame, walked
    through nested containers at any depth (the pickle fallback lays the
    same arrays out 64-byte aligned), so ``encode``'s first buffer fits a
    large value: each retry zero-fills a buffer four times larger."""
    t = type(v)
    if t is tuple or t is list:
        return 16 + sum(_size_hint(x, np) for x in v)
    if t is dict:
        return 16 + sum(_size_hint(k, np) + _size_hint(x, np) for k, x in v.items())
    if t is bytes or t is str:
        return 16 + len(v)
    if np is not None and t is np.ndarray:
        return v.nbytes + 64 + 16 * 8
    return 16


def encode(value: Any, tag: int = 0, trace: Any = None) -> bytes:
    """Encode to a fresh bytes object (socket frames, tests)."""
    size = 256 + _size_hint(value, sys.modules.get("numpy"))
    while True:
        buf = bytearray(size)
        try:
            n = encode_into(memoryview(buf), value, tag, trace)
            return bytes(buf[:n])
        except (struct.error, ValueError, IndexError):
            size *= 4
            if size > 1 << 34:
                raise


def _need(view: memoryview, off: int, n: int) -> None:
    """Bounds check BEFORE slicing: ``view[off:off+n]`` silently
    truncates past the end, which would turn a truncated encoding into a
    wrong (shorter) value instead of a typed error."""
    if off + n > len(view):
        raise WireFormatError(
            f"truncated wire payload: need {n} bytes at offset {off}, "
            f"have {len(view) - off}"
        )


def _dec(view: memoryview, off: int, copy_arrays: bool) -> Tuple[Any, int]:
    code = view[off]
    off += 1
    if code == NONE:
        return None, off
    if code == TRUE:
        return True, off
    if code == FALSE:
        return False, off
    if code == I64:
        return _I64.unpack_from(view, off)[0], off + 8
    if code == BIGINT:
        (n,) = _U32.unpack_from(view, off)
        off += 4
        _need(view, off, n)
        return int.from_bytes(view[off : off + n], "little", signed=True), off + n
    if code == F64:
        return _F64.unpack_from(view, off)[0], off + 8
    if code == BYTES:
        (n,) = _U32.unpack_from(view, off)
        off += 4
        _need(view, off, n)
        return bytes(view[off : off + n]), off + n
    if code == STR:
        (n,) = _U32.unpack_from(view, off)
        off += 4
        _need(view, off, n)
        return str(view[off : off + n], "utf-8"), off + n
    if code == TUPLE or code == LIST:
        n = view[off]
        off += 1
        items = []
        for _ in range(n):
            item, off = _dec(view, off, copy_arrays)
            items.append(item)
        return (tuple(items) if code == TUPLE else items), off
    if code == DICT:
        (n,) = _U32.unpack_from(view, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(view, off, copy_arrays)
            v, off = _dec(view, off, copy_arrays)
            d[k] = v
        return d, off
    if code == NDARRAY:
        import numpy as np

        ds_len = view[off]
        off += 1
        _need(view, off, ds_len)
        dt = np.dtype(str(view[off : off + ds_len], "ascii"))
        off += ds_len
        ndim = view[off]
        off += 1
        shape = []
        for _ in range(ndim):
            shape.append(_U64.unpack_from(view, off)[0])
            off += 8
        (nb,) = _U64.unpack_from(view, off)
        off += 8
        _need(view, off, nb)
        arr = np.frombuffer(view[off : off + nb], dtype=dt).reshape(shape)
        if copy_arrays:
            arr = arr.copy()
        return arr, off + nb
    raise WireFormatError(f"unknown wire type code {code}")


def decode(view: memoryview, copy_arrays: bool = True) -> Tuple[int, Any]:
    """Decode one value; returns ``(tag, value)``.

    ``copy_arrays=True`` materializes array payloads (required when
    ``view`` is a reusable ring that the writer will overwrite after the
    ack); ``False`` lets arrays alias ``view`` (safe for one-shot socket
    frames the receiver owns).

    Malformed input (truncated / bit-flipped / unknown type code) raises
    the typed ``WireFormatError`` — never a partial value, never a raw
    struct/index error, never a hang (every decode loop is bounded by a
    length field that is bounds-checked before use).
    """
    view = view.cast("B") if view.format != "B" else view
    try:
        tag = view[0]
        body = 1 + TRACE_LEN if tag & TRACE_FLAG else 1
        tag &= TAG_MASK
        is_pickle = view[body] == PICKLE
    except IndexError as e:
        raise WireFormatError(f"truncated wire header: {e}") from e
    if is_pickle:
        # The embedded pickle rides a CRC-validated frame in production,
        # so a failure here is usually APPLICATION-level (an unimportable
        # class on the reader, a failing __setstate__) — those propagate
        # as themselves; labeling them corruption would fail-close a
        # healthy edge and raise a false corruption alarm.  Structural
        # failures (truncated/flipped pickle in direct or fuzz use)
        # still surface as the typed error.
        try:
            _inner_tag, value = serialization.deserialize(view[body + 1 :])
            return tag, value
        except (ImportError, AttributeError, NameError):
            raise  # class-resolution / app-level: not a framing problem
        except Exception as e:  # noqa: BLE001 — structural: typed
            raise WireFormatError(f"malformed pickle payload: {e}") from e
    try:
        value, _ = _dec(view, body, copy_arrays)
        return tag, value
    except WireFormatError:
        raise
    except Exception as e:  # noqa: BLE001 — any escape = malformed input
        raise WireFormatError(f"malformed wire payload: {e}") from e


def decode_traced(
    view: memoryview, copy_arrays: bool = True
) -> Tuple[int, Any, Any]:
    """Decode one value plus its trace trailer; returns ``(tag, value,
    trace)`` where ``trace`` is ``None`` for untraced frames and
    ``(trace_id_hex, parent_span_id_hex, flags, write_ts)`` otherwise.
    Same error contract as :func:`decode`."""
    view = view.cast("B") if view.format != "B" else view
    try:
        flagged = view[0] & TRACE_FLAG
    except IndexError as e:
        raise WireFormatError(f"truncated wire header: {e}") from e
    if not flagged:
        tag, value = decode(view, copy_arrays)
        return tag, value, None
    _need(view, 1, TRACE_LEN)
    tid, psid, flags, write_ts = _TRACE.unpack_from(view, 1)
    tag, value = decode(view, copy_arrays)
    return tag, value, (tid.hex(), psid.hex(), flags, write_ts)
