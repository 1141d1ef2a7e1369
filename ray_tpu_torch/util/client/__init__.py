"""Ray Client: remote drivers over a thin RPC proxy (reference:
python/ray/util/client/ARCHITECTURE.md — a server that is itself a
normal driver, doing all bookkeeping for connected clients; the client
side holds stubs).

Here the same shape, minus gRPC: the head node runs a client server
process that is an ordinary ray_tpu_torch driver; ``ray_tpu_torch.init("ray://host:port")``
swaps the process-global worker for a :class:`ClientWorker` that
forwards the Worker interface (submit_task / create_actor /
submit_actor_task / get / put / wait / kill) over the framed-pickle RPC
— so `@ray_tpu_torch.remote` functions, actor handles, and ObjectRefs work
unchanged on top of it.  Per-connection references are pinned
server-side and released when client refs die or the client
disconnects.
"""

from ray_tpu_torch.util.client.worker import ClientWorker, connect

__all__ = ["ClientWorker", "connect"]
