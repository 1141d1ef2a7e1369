"""Worker-node process: one raylet + embedded object store.

(reference: src/ray/raylet/main.cc:123 — raylet embedding plasma.)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.raylet import Raylet


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--raylet-address", required=True)
    parser.add_argument("--store-dir", required=True)
    parser.add_argument("--resources", required=True)
    parser.add_argument("--config", default="")
    parser.add_argument("--owner-pid", type=int, default=0)
    parser.add_argument("--labels", default="{}")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    if args.config:
        CONFIG.load_overrides(args.config)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)

    raylet = Raylet(
        node_id=NodeID.from_random(),
        address=args.raylet_address,
        gcs_address=args.gcs_address,
        store_dir=args.store_dir,
        resources=json.loads(args.resources),
        labels=json.loads(args.labels),
        session_dir=args.session_dir,
        loop=loop,
    )

    stop_event = asyncio.Event()

    def _sig(*_):
        loop.call_soon_threadsafe(stop_event.set)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)


    async def run():
        raylet.on_fatal = stop_event.set
        await raylet.start()
        from ray_tpu_torch._private.node import owner_watchdog

        watchdog_task = (
            asyncio.ensure_future(owner_watchdog(args.owner_pid, stop_event))
            if args.owner_pid
            else None
        )
        await stop_event.wait()
        try:
            await asyncio.wait_for(raylet.stop(), timeout=4)
        except Exception:
            pass

    loop.run_until_complete(run())


if __name__ == "__main__":
    main()
