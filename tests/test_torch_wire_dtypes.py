"""Values the buffer protocol refuses, on the port's wire and channels.

The JAX package's ``wire._enc_array`` copies every numpy dtype through
``memoryview(arr).cast("B")``, which raises ``ValueError`` for a dtype
the buffer protocol refuses (``datetime64``, ml_dtypes' bfloat16, and a
``jax.Array`` in bf16 after ``np.asarray``).  Its channel writers read
that ``ValueError`` as "the value does not fit": an empty ring raises
``ChannelCapacityError``, and ``encode`` and the socket writer grow
their buffers first.  The port sends such an array, and any
``torch.Tensor`` (bf16 included), through the pickle fallback, so each
crosses a ring and a socket channel as itself, and quickly.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu._private import wire as jwire
from ray_tpu_torch._private import wire
from ray_tpu_torch.experimental.channel import Channel, SocketListener, dial

torch.set_num_threads(2)


def _values():
    import ml_dtypes

    return {
        "torch_bf16": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16),
        "datetime64": np.arange("2026-01-01", "2026-01-09", dtype="datetime64[D]"),
        "numpy_bf16": np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16),
    }


def _same(got, want) -> bool:
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.device.type == "cpu" and torch.equal(got, want))
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["torch_bf16", "datetime64", "numpy_bf16"])
def test_refused_dtypes_round_trip_the_wire(name):
    v = _values()[name]
    t0 = time.perf_counter()
    frame = wire.encode(v, tag=0)
    tag, out = wire.decode(memoryview(frame))
    assert time.perf_counter() - t0 < 1.0
    assert frame[1] == wire.PICKLE and tag == 0 and _same(out, v)


@pytest.mark.parametrize("name", ["torch_bf16", "datetime64", "numpy_bf16"])
def test_refused_dtypes_cross_a_ring_channel(name, tmp_path):
    v = _values()[name]
    path = str(tmp_path / "ring")
    Channel.create_file(path, 64 * 1024)
    w, r = Channel(path), Channel(path)
    t0 = time.perf_counter()
    w.write_value(v, timeout=5)
    tag, out = r.read_value(timeout=5)
    assert time.perf_counter() - t0 < 1.0
    assert tag == 0 and _same(out, v)
    w.close()
    r.close()


@pytest.mark.parametrize("name", ["torch_bf16", "datetime64", "numpy_bf16"])
def test_refused_dtypes_cross_a_socket_channel(name):
    v = _values()[name]
    lst = SocketListener()
    got = {}

    def reader():
        ch = lst.accept("read", timeout=10)
        got["value"] = ch.read_value(timeout=10)
        ch.close()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    w = dial(("127.0.0.1", lst.port), "write", timeout=10)
    t0 = time.perf_counter()
    w.write_value(v, timeout=10)
    t.join(10)
    assert time.perf_counter() - t0 < 1.0
    tag, out = got["value"]
    assert tag == 0 and _same(out, v)
    w.close()
    lst.close()


def test_a_tensor_inside_a_container_reads_back_with_its_dtype():
    """A tensor inside a fast-path container sends the whole value through
    the pickle fallback, which runs the port's pickler (the one that
    moves a card tensor to the host); it comes back unchanged."""
    v = torch.randn(2, 3, generator=torch.Generator().manual_seed(0)).to(torch.float64)
    tag, out = wire.decode(memoryview(wire.encode({"logits": v, "ids": [1, 2]})))
    assert torch.equal(out["logits"], v) and out["logits"].dtype == torch.float64
    assert out["ids"] == [1, 2]


def test_reference_encode_into_refuses_datetime64():
    """Why the port differs: the JAX package's encoder raises the
    ValueError that its channel writers take for "does not fit".  Called
    on a small fixed buffer only: the reference's ``encode`` retries with
    buffers four times larger each time, up to 16 GiB."""
    arr = _values()["datetime64"]
    buf = memoryview(bytearray(4096))
    with pytest.raises(ValueError, match="cannot include dtype"):
        jwire.encode_into(buf, arr)
    assert wire.encode_into(buf, arr) < len(buf)
