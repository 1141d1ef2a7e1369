"""Object serialization: cloudpickle + pickle-5 out-of-band zero-copy buffers.

Equivalent of the reference's serialization boundary (reference:
python/ray/_private/serialization.py — cloudpickle with pickle5 out-of-band
buffers for numpy/arrow).  Layout is a flat self-describing blob so a
shared-memory mapping of the blob can be deserialized with every large
array buffer aliasing the mapping (true zero-copy get):

    [u8 tag][u32 n_buffers][u64 buf_len]*n  [u32 pickle_len][pickle]
    [pad to 64B alignment][buffer 0][pad][buffer 1]...

Buffers are 64-byte aligned so numpy vectorized loads are happy.
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, List, Tuple

import cloudpickle

ALIGNMENT = 64

# Object tags (first byte of every stored object).
TAG_NORMAL = 0
TAG_ERROR = 1  # payload is a pickled exception to re-raise on get
TAG_INLINE_REF = 2  # reserved
# Compiled-DAG execute_many: the payload is a LIST carrying one entry
# per execution (K executions amortized into one channel write per
# edge); per-entry errors ride as RayTaskError values inside the list.
TAG_BATCH = 3

_HEADER = struct.Struct("<BI")
_BUFLEN = struct.Struct("<Q")
_PLEN = struct.Struct("<I")


def _align(n: int) -> int:
    return (n + ALIGNMENT - 1) & ~(ALIGNMENT - 1)


def _device_tensor_class():
    """``torch.Tensor`` if torch is already imported in this process, else
    None: the core never imports torch itself (the raylet, the GCS and
    every pooled worker would pay for the import at start-up)."""
    torch = sys.modules.get("torch")
    # getattr, not attribute access: a worker dying mid-`import torch` has
    # a partially initialized module in sys.modules without `Tensor`, and
    # the ERROR-serialization path must never itself raise
    return getattr(torch, "Tensor", None) if torch is not None else None


class _Pickler(cloudpickle.Pickler):
    def __init__(self, file, buffers: List[memoryview]):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)

    def reducer_override(self, obj):
        tensor = _device_tensor_class()
        if tensor is not None and isinstance(obj, tensor) and obj.device.type != "cpu":
            # A tensor on the card is moved to host memory before
            # pickling, so it unpickles as a CPU tensor in any process: a
            # CUDA tensor would fail to load where there is no card and
            # make a CUDA context where there is one.
            return (_restore_host_tensor, (obj.to("cpu"),))
        return super().reducer_override(obj)


def _restore_host_tensor(tensor):
    # Deserialized on the consumer as a CPU tensor; the consumer decides
    # when to move it to the card (device placement is never implicit on
    # get).
    return tensor


def serialize(value: Any, tag: int = TAG_NORMAL) -> Tuple[bytes, List[memoryview]]:
    """Returns (header+pickle bytes, raw buffers). Total layout computed by
    pack_into_size/write_into for single-copy writes into shared memory."""
    import io

    buffers: List[memoryview] = []
    f = io.BytesIO()
    p = _Pickler(f, buffers)
    p.dump(value)
    pickled = f.getvalue()
    raw_buffers = [memoryview(b).cast("B") for b in buffers]
    return _build_meta(tag, pickled, raw_buffers), raw_buffers


def _build_meta(tag: int, pickled: bytes, buffers: List[memoryview]) -> bytes:
    parts = [_HEADER.pack(tag, len(buffers))]
    for b in buffers:
        parts.append(_BUFLEN.pack(b.nbytes))
    parts.append(_PLEN.pack(len(pickled)))
    parts.append(pickled)
    return b"".join(parts)


def total_size(meta: bytes, buffers: List[memoryview]) -> int:
    n = _align(len(meta))
    for b in buffers:
        n = _align(n + b.nbytes)
    return n


def write_into(dest: memoryview, meta: bytes, buffers: List[memoryview]) -> int:
    """Write the serialized object into a destination mapping. Returns bytes
    written. Buffer copies are the only data copies on the put path."""
    off = len(meta)
    dest[:off] = meta
    off = _align(off)
    for b in buffers:
        dest[off : off + b.nbytes] = b
        off = _align(off + b.nbytes)
    return off


def serialize_to_bytes(value: Any, tag: int = TAG_NORMAL) -> bytes:
    meta, buffers = serialize(value, tag)
    out = bytearray(total_size(meta, buffers))
    write_into(memoryview(out), meta, buffers)
    return bytes(out)


def deserialize(view: memoryview) -> Tuple[int, Any]:
    """Deserialize from a mapping; array buffers alias `view` (zero-copy).

    Returns (tag, value).
    """
    view = view.cast("B") if view.format != "B" else view
    tag, n_buffers = _HEADER.unpack_from(view, 0)
    off = _HEADER.size
    buf_lens = []
    for _ in range(n_buffers):
        (blen,) = _BUFLEN.unpack_from(view, off)
        buf_lens.append(blen)
        off += _BUFLEN.size
    (plen,) = _PLEN.unpack_from(view, off)
    off += _PLEN.size
    pickled = bytes(view[off : off + plen])
    off = _align(off + plen)
    buffers = []
    for blen in buf_lens:
        buffers.append(view[off : off + blen])
        off = _align(off + blen)
    value = pickle.loads(pickled, buffers=buffers)
    return tag, value


def buffer_count(view: memoryview) -> int:
    """Number of out-of-band buffers in a serialized blob (header peek).
    Zero means a deserialized value holds no aliases into the blob."""
    view = view.cast("B") if view.format != "B" else view
    _, n_buffers = _HEADER.unpack_from(view, 0)
    return n_buffers


def dumps_function(fn) -> bytes:
    """Pickle a function/class definition for the GCS function table."""
    return cloudpickle.dumps(fn, protocol=5)


def loads_function(blob: bytes):
    return cloudpickle.loads(blob)
