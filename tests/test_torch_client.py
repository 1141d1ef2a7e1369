"""Ray Client of the port: remote drivers over ray:// (copies of
tests/test_client.py over the port's cluster, whose head starts the
client server; no JAX.  Reference: util/client/ARCHITECTURE.md — server
is a normal driver; client holds stubs and the server does all
bookkeeping)."""

import os
import socket
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import retry


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _poll(deadline_s: float):
    """Yield once now, then after each backoff delay of the runtime's POLL
    policy until ``deadline_s`` has passed."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    yield
    while (delay := bo.next_delay()) is not None:
        time.sleep(delay)
        yield


@pytest.fixture(scope="module")
def client_server():
    """The port's cluster with its head's client server on a free port
    (the reference's test starts the server by hand; this one takes the
    head's ray_client_server_port path, which spawns
    ray_tpu_torch.util.client.server_main)."""
    port = _free_port()
    with pytest.MonkeyPatch.context() as mp:
        # The suite runs many clusters at once: no shm arena prefault per
        # raylet, and no memory monitor (it watches the whole machine).
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        mp.setenv("RAY_TPU_TORCH_ray_client_server_port", str(port))
        ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
        from ray_tpu_torch._private import rpc

        # Wait for it to listen.
        for _ in _poll(30):
            try:
                rpc.RpcClient(f"tcp:127.0.0.1:{port}").close()
                break
            except Exception:
                pass
        yield f"ray://127.0.0.1:{port}"
        ray_tpu_torch.shutdown()


def _run_client(code: str) -> str:
    """Run a driver script in a FRESH interpreter (a true remote client:
    no shared state with the cluster process)."""
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_client_tasks_actors_objects(client_server):
    out = _run_client(
        f'''
import ray_tpu_torch
ray_tpu_torch.init(address="{client_server}")

@ray_tpu_torch.remote
def f(x):
    return x * 2

assert ray_tpu_torch.get(f.remote(21)) == 42

@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0
    def incr(self, k):
        self.n += k
        return self.n

c = Counter.remote()
assert ray_tpu_torch.get(c.incr.remote(5)) == 5
assert ray_tpu_torch.get(c.incr.remote(7)) == 12

ref = ray_tpu_torch.put({{"k": [1, 2, 3]}})
assert ray_tpu_torch.get(ref) == {{"k": [1, 2, 3]}}

r1, r2 = f.remote(1), f.remote(2)
ready, rest = ray_tpu_torch.wait([r1, r2], num_returns=2, timeout=30)
assert len(ready) == 2 and not rest

# refs as args cross the wire by id
big = ray_tpu_torch.put(list(range(100)))
@ray_tpu_torch.remote
def total(xs):
    return sum(xs)
assert ray_tpu_torch.get(total.remote(big)) == 4950

ray_tpu_torch.shutdown()
print("CLIENT-OK")
'''
    )
    assert "CLIENT-OK" in out


def test_client_errors_propagate(client_server):
    out = _run_client(
        f'''
import ray_tpu_torch
ray_tpu_torch.init(address="{client_server}")

@ray_tpu_torch.remote(max_retries=0)
def boom():
    raise ValueError("kapow")

try:
    ray_tpu_torch.get(boom.remote(), timeout=60)
    raise SystemExit("no raise")
except ValueError:
    print("ERROR-OK")
ray_tpu_torch.shutdown()
'''
    )
    assert "ERROR-OK" in out


def test_client_runtime_env_and_namespace(client_server, tmp_path):
    """runtime_env is packaged on the CLIENT machine (working_dir zip of
    the client's filesystem, shipped via the server into the GCS KV) and
    namespace is the client driver's, not the server's (reference: ray
    client applies the job runtime_env from the remote driver)."""
    wd = tmp_path / "client_wd"
    wd.mkdir()
    (wd / "client_data.txt").write_text("from-the-client-box")
    out = _run_client(
        f'''
import ray_tpu_torch
ray_tpu_torch.init(
    address="{client_server}",
    namespace="client-ns",
    runtime_env={{"working_dir": r"{wd}", "env_vars": {{"CLIENT_RE": "yes"}}}},
)

@ray_tpu_torch.remote
def read():
    import os
    return open("client_data.txt").read(), os.environ.get("CLIENT_RE")

data, ev = ray_tpu_torch.get(read.remote(), timeout=60)
assert data == "from-the-client-box", data
assert ev == "yes", ev

@ray_tpu_torch.remote
class Named:
    def ping(self):
        return "ns-ok"

n = Named.options(name="client_named", lifetime="detached").remote()
assert ray_tpu_torch.get(n.ping.remote()) == "ns-ok"
# Lookup without an explicit namespace must resolve in the client's.
h = ray_tpu_torch.get_actor("client_named")
assert ray_tpu_torch.get(h.ping.remote()) == "ns-ok"
ray_tpu_torch.kill(h)
print("CLIENT-ENV-OK")
'''
    )
    assert "CLIENT-ENV-OK" in out


def test_client_rejects_cluster_shaping_args(client_server):
    out = _run_client(
        f'''
import ray_tpu_torch
try:
    ray_tpu_torch.init(address="{client_server}", num_cpus=4)
    raise SystemExit("no raise")
except ValueError as e:
    assert "num_cpus" in str(e)
    print("REJECT-OK")
'''
    )
    assert "REJECT-OK" in out


def test_client_disconnect_releases_actors(client_server):
    """Non-detached actors created by a client die with its connection
    (reference: server release_all on disconnect)."""
    _run_client(
        f'''
import ray_tpu_torch
ray_tpu_torch.init(address="{client_server}")

@ray_tpu_torch.remote
class Ghost:
    def ping(self):
        return 1

g = Ghost.remote()
assert ray_tpu_torch.get(g.ping.remote()) == 1
# exit WITHOUT killing: the server must clean up on disconnect
'''
    )
    alive = []
    for _ in _poll(30):
        alive = [
            a
            for a in ray_tpu_torch.util.state.list_actors()
            if a["state"] == "ALIVE" and "Ghost" in a["class_name"]
        ]
        if not alive:
            return
    raise AssertionError(f"client's actors survived disconnect: {alive}")


def test_client_server_exits_with_its_head():
    """The head's client server goes down with the head: the head keeps
    serving until the server's driver has disconnected (the reference's
    server outlives its head for the GCS reconnect window)."""
    port = _free_port()
    code = f'''
import json, os, time
import ray_tpu_torch
ray_tpu_torch.init(num_cpus=1)
from ray_tpu_torch._private import rpc
deadline = time.monotonic() + 30
while True:
    try:
        rpc.RpcClient("tcp:127.0.0.1:{port}").close()
        break
    except Exception:
        assert time.monotonic() < deadline, "client server never listened"
        time.sleep(0.1)
pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
def server_pids():
    out = []
    for p in pids:
        try:
            with open(f"/proc/{{p}}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split(chr(0))
        except OSError:
            continue
        if "ray_tpu_torch.util.client.server_main" in argv and "tcp:127.0.0.1:{port}" in argv:
            out.append(p)
    return out
found = server_pids()
t0 = time.monotonic()
ray_tpu_torch.shutdown()
print(json.dumps({{"found": found, "shutdown_s": time.monotonic() - t0}}))
'''
    env = dict(
        os.environ,
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        RAY_TPU_TORCH_ray_client_server_port=str(port),
        RAY_TPU_TORCH_arena_prefault_bytes="0",
        RAY_TPU_TORCH_memory_monitor_enabled="0",
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    import json

    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(out["found"]) == 1, out
    pid = out["found"][0]
    for _ in _poll(10):
        if not os.path.exists(f"/proc/{pid}") or _zombie(pid):
            break
    assert not os.path.exists(f"/proc/{pid}") or _zombie(pid), (
        f"the client server {pid} outlived its head")


def _zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True
