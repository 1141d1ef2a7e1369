"""Client server entrypoint: a driver process hosting ClientServer
(reference: util/client/server/__main__ — `ray start --head` launches
it next to the GCS)."""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--listen", required=True, help="tcp:host:port or unix:path")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, format="[client-server %(asctime)s] %(message)s")

    import ray_tpu_torch

    ray_tpu_torch.init(address=args.gcs_address, log_to_driver=False)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    from ray_tpu_torch.util.client.server import ClientServer

    server = ClientServer(args.listen, loop)
    stop = asyncio.Event()
    signal.signal(signal.SIGTERM, lambda *_: loop.call_soon_threadsafe(stop.set))
    signal.signal(signal.SIGINT, lambda *_: loop.call_soon_threadsafe(stop.set))

    async def run():
        await server.start()
        await stop.wait()

    loop.run_until_complete(run())
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
