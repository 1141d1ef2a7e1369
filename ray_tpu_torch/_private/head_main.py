"""Head-node process: GCS + head raylet on one asyncio loop.

(reference: src/ray/gcs/gcs_server/gcs_server_main.cc + raylet/main.cc:123
— two processes there; co-hosted here, same protocols.)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.gcs_server import GcsServer
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
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s")
    if args.config:
        CONFIG.load_overrides(args.config)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)

    gcs = GcsServer(args.gcs_address, {"session_dir": args.session_dir}, loop=loop)
    raylet = Raylet(
        node_id=NodeID.from_random(),
        address=args.raylet_address,
        gcs_address=args.gcs_address,
        store_dir=args.store_dir,
        resources=json.loads(args.resources),
        is_head=True,
        session_dir=args.session_dir,
        loop=loop,
    )

    stop_event = asyncio.Event()

    def _sig(*_):
        loop.call_soon_threadsafe(stop_event.set)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)


    async def run():
        await gcs.start()
        await raylet.start()
        if CONFIG.dashboard_port >= 0:
            # HTTP API + job submission, in-process (reference runs
            # dashboard.py as its own process; same routes).
            try:
                from ray_tpu_torch.dashboard import start_dashboard

                server = start_dashboard(
                    args.gcs_address,
                    args.session_dir,
                    host=CONFIG.dashboard_host,
                    port=CONFIG.dashboard_port,
                )
                if server is not None:
                    gcs.session_info["dashboard_url"] = (
                        f"http://{server.server_address[0]}:{server.server_address[1]}"
                    )
            except Exception:
                logging.getLogger(__name__).exception("dashboard failed to start")
        client_server_proc = None
        if CONFIG.ray_client_server_port >= 0:
            # ray:// remote-driver endpoint, its own driver process
            # (reference: util/client/server launched by `ray start`).
            import subprocess
            import sys as _sys

            from ray_tpu_torch._private.node import child_env

            with open(f"{args.session_dir}/logs/client_server.log", "ab") as cs_log:
                client_server_proc = subprocess.Popen(
                    [
                        _sys.executable, "-m", "ray_tpu_torch.util.client.server_main",
                        "--gcs-address", args.gcs_address,
                        "--listen",
                        f"tcp:{CONFIG.ray_client_server_host}:"
                        f"{CONFIG.ray_client_server_port or 10001}",
                    ],
                    env=child_env(),
                    stdout=cs_log,
                    stderr=subprocess.STDOUT,
                )
        from ray_tpu_torch._private.node import owner_watchdog

        watchdog_task = (
            asyncio.ensure_future(owner_watchdog(args.owner_pid, stop_event))
            if args.owner_pid
            else None
        )
        await stop_event.wait()
        if client_server_proc is not None and client_server_proc.poll() is None:
            client_server_proc.terminate()  # dies with the cluster, not after it
            # Port: the server's driver disconnects from this GCS on its
            # way out, and a GCS already gone parks it in the reconnect
            # window for a minute (the reference's server outlives its
            # head): keep serving on this loop until it has exited, and
            # kill it after 2 s.
            deadline = loop.time() + 2.0
            while client_server_proc.poll() is None and loop.time() < deadline:
                await asyncio.sleep(0.05)
            if client_server_proc.poll() is None:
                client_server_proc.kill()
        try:
            await asyncio.wait_for(raylet.stop(), timeout=4)
            await asyncio.wait_for(gcs.stop(), timeout=2)
        except Exception:
            pass

    loop.run_until_complete(run())


if __name__ == "__main__":
    main()
