"""DataIterator: batched consumption of a stream of block refs.

Reference: python/ray/data/iterator.py (iter_batches :94,
iter_torch_batches :232); the device path (`iter_device_batches`, the
counterpart of the reference's `iter_jax_batches`) lands batches on the
card through pinned buffers and a copy stream of its own, double-buffered
so the host-to-card copy overlaps the training step.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor


def _batcher(
    numpy_blocks: Iterator[Dict[str, np.ndarray]],
    batch_size: Optional[int],
    drop_last: bool,
) -> Iterator[Dict[str, np.ndarray]]:
    """Re-batch a stream of column-dict blocks into exact batch_size chunks,
    carrying remainders across block boundaries."""
    if batch_size is None:
        yield from (b for b in numpy_blocks if next(iter(b.values()), np.empty(0)).shape[0] > 0)
        return
    carry: Optional[Dict[str, np.ndarray]] = None
    for block in numpy_blocks:
        if not block:
            continue
        if carry is not None:
            block = {k: np.concatenate([carry[k], block[k]]) for k in block}
            carry = None
        n = next(iter(block.values())).shape[0]
        lo = 0
        while n - lo >= batch_size:
            yield {k: v[lo : lo + batch_size] for k, v in block.items()}
            lo += batch_size
        if lo < n:
            carry = {k: v[lo:] for k, v in block.items()}
    if carry is not None and not drop_last:
        yield carry


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Run `it` on a background thread with a bounded queue.

    If the consumer stops early (break / GeneratorExit), the producer is
    signalled to stop and the upstream iterator is closed so its
    finalizers run (e.g. the streaming executor killing its actor pools)
    — otherwise the thread would block forever on the full queue and the
    upstream resources would leak for the life of the driver."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def worker():
        try:
            for x in it:
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            err.append(e)
        finally:
            if stop.is_set():
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except BaseException:  # noqa: BLE001
                        pass
            while True:
                if stop.is_set():
                    # consumer is gone: evicting queued items is fine
                    try:
                        q.put_nowait(DONE)
                        break
                    except queue.Full:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass
                else:
                    try:
                        q.put(DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is DONE:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
        try:  # wake a producer blocked on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


class DataIterator:
    """One logical consumer of a dataset stream. ``block_iter_factory``
    returns a fresh iterator of block ObjectRefs per epoch."""

    def __init__(self, block_iter_factory: Callable[[], Iterator[Any]]):
        self._factory = block_iter_factory

    def _numpy_blocks(self, columns=None) -> Iterator[Dict[str, np.ndarray]]:
        for ref in self._factory():
            block = ray_tpu_torch.get(ref) if not hasattr(ref, "num_rows") else ref
            yield BlockAccessor.for_block(block).to_numpy(columns)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
        columns: Optional[List[str]] = None,
    ) -> Iterator[Any]:
        it = self._numpy_blocks(columns)
        if local_shuffle_buffer_size:
            it = _local_shuffle(it, local_shuffle_buffer_size, local_shuffle_seed)
        batches = _batcher(it, batch_size, drop_last)
        if batch_format in ("numpy", "default"):
            out = batches
        elif batch_format == "pandas":
            import pandas as pd

            out = (pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in b.items()}) for b in batches)
        elif batch_format in ("pyarrow", "arrow"):
            from ray_tpu_torch.data.block import build_block

            out = (build_block(b) for b in batches)
        else:
            raise ValueError(f"unknown batch_format {batch_format!r}")
        if prefetch_batches and prefetch_batches > 0:
            out = _prefetch(out, prefetch_batches)
        return out

    def iter_rows(self) -> Iterator[dict]:
        for ref in self._factory():
            block = ray_tpu_torch.get(ref) if not hasattr(ref, "num_rows") else ref
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_device_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device: Any = "cuda",
        sharding: Optional[Any] = None,
        drop_last: bool = True,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 2,
        columns: Optional[List[str]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield batches as torch tensors already resident on ``device``.

        The counterpart of the reference's ``iter_jax_batches``: the same
        host pipeline, then each column is cast on the host (``dtypes``
        maps a column to a ``torch.dtype``), copied into a pinned buffer
        and sent to the card with a non-blocking copy on a stream of its
        own. With ``prefetch_batches`` > 0 a producer thread runs that
        copy one or more batches ahead, so while step N computes, batch
        N+1 is on its way (see ``_DeviceStager``). ``device="cpu"``
        yields CPU tensors through the same pipeline, with no stream.

        With ``sharding`` (a ``parallel.sharding.NamedSharding``, e.g. a
        GSPMD plan's ``data_sharding()``) each column is laid out across
        the mesh as a DTensor on the mesh's device (``device`` is then
        the mesh's): the batch this iterator yields is the global batch,
        and each rank keeps its window of it over the spec's axes (the
        batch axis, and ``sp``'s window of the sequence where the spec
        names it), so a sharded step consumes it without a collective.
        """
        import torch

        if sharding is not None:
            from ray_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(sharding.mesh)
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "iter_device_batches: no CUDA device; pass device='cpu' for host tensors"
                )
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        host_batches = self.iter_batches(
            batch_size=batch_size,
            batch_format="numpy",
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed,
            prefetch_batches=0,
            columns=columns,
        )
        if dev.type != "cuda":

            def to_host(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
                out = {}
                for k, v in batch.items():
                    # np.array copies: the batch may be a read-only view of
                    # a block in the object store.
                    t = torch.from_numpy(np.array(v))
                    if dtypes and k in dtypes:
                        t = t.to(dtypes[k])
                    out[k] = t.to(dev)
                return out

            it = (to_host(b) for b in host_batches)
            if prefetch_batches and prefetch_batches > 0:
                it = _prefetch(it, prefetch_batches)
        else:
            stager = _DeviceStager(dev, dtypes)
            staged = stager.stage_all(host_batches)
            if prefetch_batches and prefetch_batches > 0:
                staged = _prefetch(staged, prefetch_batches)
            it = stager.hand_out(staged)
        return it if sharding is None else _laid_out(it, sharding)

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device: str = "cpu",
        drop_last: bool = False,
        prefetch_batches: int = 1,
    ) -> Iterator[Dict[str, Any]]:
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size, drop_last=drop_last, prefetch_batches=prefetch_batches
        ):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t.to(device)
            yield out

    def materialize_numpy(self, columns=None) -> Dict[str, np.ndarray]:
        blocks = list(self._numpy_blocks(columns))
        if not blocks:
            return {}
        return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def _local_shuffle(
    blocks: Iterator[Dict[str, np.ndarray]], buffer_rows: int, seed: Optional[int]
) -> Iterator[Dict[str, np.ndarray]]:
    """Row-level shuffle within a bounded buffer (reference:
    _internal/block_batching/iter_batches.py local shuffle)."""
    rng = np.random.default_rng(seed)
    buf: Optional[Dict[str, np.ndarray]] = None
    for block in blocks:
        buf = block if buf is None else {
            k: np.concatenate([buf[k], block[k]]) for k in block
        }
        n = next(iter(buf.values())).shape[0]
        while n >= buffer_rows:
            perm = rng.permutation(n)
            take, rest = perm[:buffer_rows], perm[buffer_rows:]
            yield {k: v[take] for k, v in buf.items()}
            buf = {k: v[rest] for k, v in buf.items()}
            n = len(rest)
    if buf is not None:
        n = next(iter(buf.values())).shape[0]
        if n:
            perm = rng.permutation(n)
            yield {k: v[perm] for k, v in buf.items()}


def _laid_out(batches: Iterator[Dict[str, Any]], sharding: Any) -> Iterator[Dict[str, Any]]:
    """Each column of each batch as a DTensor with ``sharding``'s spec,
    clipped to the column's rank, every rank keeping its own window."""
    from ray_tpu_torch.parallel.sharding import _clip_spec, place, spec_to_placements

    try:
        for batch in batches:
            yield {k: place(v, sharding.mesh,
                            spec_to_placements(_clip_spec(sharding.spec, tuple(v.shape)),
                                               sharding.mesh))
                   for k, v in batch.items()}
    finally:
        batches.close()  # stops a prefetching producer with this iterator


class _DeviceStager:
    """Host-to-card copies for ``iter_device_batches``.

    ``stage_all`` runs on the producer thread (``_prefetch``'s worker, or
    the consumer's own thread at ``prefetch_batches=0``). It makes the
    card current in that thread (the current CUDA device is per thread,
    and a new thread starts on ``cuda:0``), casts each column on the host,
    copies it into a pinned buffer and issues a non-blocking copy to the
    card on its own stream, then records an event after the copies.

    Pinned buffers live in ``_SLOTS`` slots used in turn. Before a slot's
    buffers are written again, the event of the copy that last read them
    is waited on, so a copy still in flight never reads half-written rows.

    ``hand_out`` runs on the consumer's thread. It makes the consumer's
    current stream wait on the batch's event before the batch is yielded,
    and records that stream on every tensor, so the caching allocator does
    not reuse their memory while the step still reads them.
    """

    _SLOTS = 2

    def __init__(self, device, dtypes: Optional[Dict[str, Any]]):
        self._device = device
        self._dtypes = dtypes or {}
        self._slots: List[Dict[str, Any]] = [{} for _ in range(self._SLOTS)]
        self._slot_events: List[Any] = [None] * self._SLOTS

    def _pinned(self, slot: int, name: str, src):
        """Copy ``src`` into the slot's pinned buffer for ``name``, casting
        on the host to the column's dtype."""
        import torch

        dtype = self._dtypes.get(name, src.dtype)
        buf = self._slots[slot].get(name)
        if buf is None or buf.shape != src.shape or buf.dtype != dtype:
            buf = torch.empty(src.shape, dtype=dtype, pin_memory=True)
            self._slots[slot][name] = buf
        buf.copy_(src)
        return buf

    def stage_all(self, host_batches: Iterator[Dict[str, np.ndarray]]) -> Iterator[Any]:
        import torch

        stream = torch.cuda.Stream(device=self._device)
        for i, batch in enumerate(host_batches):
            slot = i % self._SLOTS
            # Entered per batch, never held across a yield: the generator
            # may be finalised on another thread.
            with torch.cuda.device(self._device):
                if self._slot_events[slot] is not None:
                    self._slot_events[slot].synchronize()
                out = {}
                with torch.cuda.stream(stream):
                    for k, v in batch.items():
                        pinned = self._pinned(slot, k, torch.as_tensor(np.ascontiguousarray(v)))
                        dst = torch.empty(pinned.shape, dtype=pinned.dtype, device=self._device)
                        dst.copy_(pinned, non_blocking=True)
                        out[k] = dst
                    event = torch.cuda.Event()
                    event.record(stream)
            self._slot_events[slot] = event
            yield out, event

    def hand_out(self, staged: Iterator[Any]) -> Iterator[Dict[str, Any]]:
        import torch

        for out, event in staged:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
            yield out
