"""Standalone GCS process (reference: gcs/gcs_server/gcs_server_main.cc).

head_main co-hosts GCS + head raylet for the common single-command
bring-up; this entrypoint runs the GCS alone so it can be restarted
independently of any raylet — the deployment shape the reference uses,
and what the GCS fault-tolerance tests exercise.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.gcs_server import GcsServer


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--config", default="")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    if args.config:
        CONFIG.load_overrides(args.config)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    gcs = GcsServer(args.address, {"session_dir": args.session_dir}, loop=loop)

    stop_event = asyncio.Event()

    def _sig(*_):
        loop.call_soon_threadsafe(stop_event.set)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)

    async def run():
        await gcs.start()
        await stop_event.wait()
        try:
            await asyncio.wait_for(gcs.stop(), timeout=2)
        except Exception:
            pass

    loop.run_until_complete(run())


if __name__ == "__main__":
    main()
