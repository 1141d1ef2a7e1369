"""Long-poll config push (reference: serve/_private/long_poll.py
LongPollHost/LongPollClient): listeners block on the controller until a
watched key's snapshot advances, so route tables and replica sets
propagate in one RTT instead of on a polling interval.

The host side is a mixin the controller actor inherits; `notify_changed`
bumps a key's snapshot id and wakes every waiter.  The client side runs
a daemon thread that loops `listen_for_change` actor calls and applies
updates via callbacks."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, Dict, Optional, Tuple

LISTEN_TIMEOUT_S = 30.0  # waiters re-arm after this (liveness under drops)


class LongPollHost:
    """Mixin for an async actor: snapshot store + change notification."""

    def _lp_state(self):
        if not hasattr(self, "_lp_snapshots"):
            self._lp_snapshots: Dict[str, Tuple[int, Any]] = {}
            self._lp_event = asyncio.Event()
        return self._lp_snapshots

    def notify_changed(self, key: str, value: Any) -> None:
        snaps = self._lp_state()
        cur_id = snaps.get(key, (0, None))[0]
        snaps[key] = (cur_id + 1, value)
        self._lp_event.set()

    async def listen_for_change(
        self, keys_to_snapshot_ids: Dict[str, int]
    ) -> Dict[str, Tuple[int, Any]]:
        """Block until any watched key's snapshot id exceeds the
        caller's; returns {key: (snapshot_id, value)} for changed keys
        (reference: long_poll.py listen_for_change).  Times out with an
        empty dict so clients re-arm."""
        snaps = self._lp_state()
        deadline = asyncio.get_event_loop().time() + LISTEN_TIMEOUT_S
        while True:
            changed = {
                k: snaps[k]
                for k, seen in keys_to_snapshot_ids.items()
                if k in snaps and snaps[k][0] > seen
            }
            if changed:
                return changed
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                return {}
            self._lp_event.clear()
            try:
                await asyncio.wait_for(self._lp_event.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return {}


class LongPollClient:
    """Daemon-thread listener applying pushed updates via callbacks."""

    def __init__(self, host_actor, callbacks: Dict[str, Callable[[Any], None]]):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self._host = host_actor
        self._callbacks = callbacks
        self._snapshot_ids = {k: 0 for k in callbacks}
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-long-poll"
        )
        self._thread.start()

    def _loop(self):
        import time

        from ray_tpu_torch._private import retry

        bo = None
        while not self._stopped:
            try:
                changed = self._ray.get(
                    self._host.listen_for_change.remote(dict(self._snapshot_ids)),
                    timeout=LISTEN_TIMEOUT_S + 30,
                )
                bo = None  # healthy again: next failure starts a fresh budget
            except Exception:
                if self._stopped:
                    return
                bo = bo or retry.SERVE_LONG_POLL.start()
                delay = bo.next_delay()
                if delay is None:
                    # host is gone (serve.shutdown killed the
                    # controller): exit instead of retrying forever
                    return
                time.sleep(delay)
                continue
            for key, (snap_id, value) in (changed or {}).items():
                self._snapshot_ids[key] = snap_id
                try:
                    self._callbacks[key](value)
                except Exception:
                    pass

    def stop(self):
        self._stopped = True
