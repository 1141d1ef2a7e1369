"""The port's wire format (ray_tpu_torch/_private/wire.py) against the JAX
package's (ray_tpu/_private/wire.py): for fast-path values made from a
seed, both encoders write the same bytes, with and without the trace
trailer, and each package decodes the other's frames to equal values.
A compiled DAG's edges and the serve dataplane's frames are these
bytes, so the two packages' channels speak one format."""

import math

import numpy as np
import pytest

from ray_tpu._private import wire as jwire
from ray_tpu_torch._private import wire as twire

# numpy dtypes the buffer protocol takes: the fast path's NDARRAY code
_DTYPES = (np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
           np.int64, np.uint64, np.float16, np.float32, np.float64, np.complex64,
           np.complex128)


def _scalar(rng, depth):
    kind = rng.integers(0, 8)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-(2**62), 2**62))
    if kind == 3:
        return int(rng.integers(1, 2**62)) << 70  # BIGINT
    if kind == 4:
        return float(rng.standard_normal())
    if kind == 5:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2600, size=rng.integers(0, 12)))
    if kind == 6:
        return rng.bytes(int(rng.integers(0, 40)))
    dt = _DTYPES[rng.integers(0, len(_DTYPES))]
    shape = tuple(int(s) for s in rng.integers(0, 4, size=rng.integers(0, 3)))
    x = np.asarray(rng.standard_normal(shape) * 50)
    return np.asarray(np.abs(x) if np.dtype(dt).kind == "u" else x).astype(dt)


def _value(rng, depth=0):
    """A fast-path value: scalars, arrays and containers nested to the
    wire's depth and width bounds."""
    if depth >= 3 or rng.random() < 0.4:
        return _scalar(rng, depth)
    n = int(rng.integers(0, 6))
    kind = rng.integers(0, 3)
    if kind == 0:
        return tuple(_value(rng, depth + 1) for _ in range(n))
    if kind == 1:
        return [_value(rng, depth + 1) for _ in range(n)]
    return {f"k{i}": _value(rng, depth + 1) for i in range(n)}


def _equal(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _values(seed: int, n: int = 200) -> list:
    rng = np.random.default_rng(seed)
    fixed = [None, True, False, 0, -1, 2**63 - 1, -(2**63), 2**64, -(2**200), 0.0, -0.0,
             float("inf"), float("nan"), "", "unicodé ☃", b"", b"\x00\xff",
             (), [], {}, np.array(7, dtype=np.int8), np.zeros((0, 3)),
             np.asfortranarray(np.arange(6.0).reshape(2, 3))]
    return fixed + [_value(rng) for _ in range(n)]


@pytest.mark.parametrize("traced", [False, True])
def test_fast_path_frames_are_byte_identical(traced):
    trace = ("0123456789abcdef0123456789abcdef", "fedcba9876543210", 1, 1234.5) if traced else None
    for tag in (0, 1):
        for v in _values(seed=11 + tag):
            want = jwire.encode(v, tag=tag, trace=trace)
            got = twire.encode(v, tag=tag, trace=trace)
            assert got == want, v
            # the fast path really carried it (no pickle fallback)
            body = 1 + twire.TRACE_LEN if traced else 1
            assert got[body] != twire.PICKLE, v


@pytest.mark.parametrize("traced", [False, True])
def test_each_package_decodes_the_others_frames(traced):
    trace = ("00112233445566778899aabbccddeeff", "0011223344556677", 0, 99.25) if traced else None
    for v in _values(seed=5):
        for enc, dec in ((jwire, twire), (twire, jwire)):
            frame = enc.encode(v, tag=1, trace=trace)
            tag, out, tr = dec.decode_traced(memoryview(frame))
            assert tag == 1 and _equal(out, v), v
            assert tr == trace


def test_encode_sizes_its_buffer_for_nested_arrays_once():
    """The port's encode sizes its first buffer from the arrays inside the
    value (a deliberate difference: the reference starts at 256 bytes and
    retries at four times the size, zero-filling each buffer), so a large
    tree fits the first buffer, on the fast path and the pickle fallback,
    and its frame is still the reference's byte for byte."""
    rng = np.random.default_rng(3)
    tree = {f"h_{i}.w": rng.standard_normal((64, 96)).astype(np.float32) for i in range(40)}
    deep = [{"state": {0: {"exp_avg": tree["h_0.w"], "step": np.array(1.0)}}},
            {"params": list(range(100))}]  # past MAX_DEPTH and MAX_ELEMS: pickled
    for v in ((tree, None), (tree, deep)):
        frame = twire.encode(v)
        assert len(frame) <= 256 + twire._size_hint(v, np)
    assert twire.encode((tree, None)) == jwire.encode((tree, None))
    assert twire.encode((tree, deep))[1] == twire.PICKLE
