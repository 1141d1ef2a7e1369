"""Node bring-up and process supervision.

Equivalent of the reference's Node/services layer (reference:
python/ray/_private/node.py:37 start_head_processes → start_gcs_server,
start_raylet; python/ray/_private/services.py).  The head process hosts
GCS + the head-node raylet in one asyncio loop (one process instead of
two — cheap on a shared box, same wire protocols); additional nodes are
raylet-only processes pointed at the GCS, which is how the multi-node
Cluster test utility works on one machine (reference:
python/ray/cluster_utils.py:135).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, Optional

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID

# The longest unix socket path under the root is the root plus 65 bytes
# (a worker's /session_<date>_<time>_<8 hex>/sockets/w_<16 hex>.sock), and
# a socket path holds at most 107.
_MAX_ROOT_LEN = 42


def _default_root() -> str:
    """``<temp dir>/ray_tpu_torch``, so that processes with temp dirs of
    their own keep their sessions and cluster-address files apart.  A temp
    dir too long for the socket paths gets a short root keyed by its own
    path instead."""
    root = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    if len(root) > _MAX_ROOT_LEN:
        key = hashlib.sha1(root.encode()).hexdigest()[:12]
        root = os.path.join("/tmp", f"ray_tpu_torch_{key}")
    return root


# The port's session root, cluster-address file, store directory and
# environment prefix are its own, so that its clusters and the JAX
# package's never attach to each other's sessions or stores.
RAY_TPU_TORCH_TMP = os.environ.get("RAY_TPU_TORCH_TMPDIR") or _default_root()
CLUSTER_ADDRESS_FILE = os.path.join(RAY_TPU_TORCH_TMP, "ray_current_cluster")


def child_env() -> dict:
    """Env for spawned processes: make sure ray_tpu_torch is importable even when
    the driver got it via sys.path manipulation rather than installation."""
    import ray_tpu_torch

    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    env = dict(os.environ)
    parts = env.get("PYTHONPATH", "").split(os.pathsep) if env.get("PYTHONPATH") else []
    if pkg_parent not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_parent] + parts)
    return env


def default_store_root(session_name: str) -> str:
    # Prefer tmpfs so object mmaps are memory-speed; the session's unique
    # name keeps its store apart from every other session's there.
    for base in ("/dev/shm", RAY_TPU_TORCH_TMP):
        try:
            os.makedirs(base, exist_ok=True)
            test = os.path.join(base, f".wtest_{os.getpid()}")
            with open(test, "w") as f:
                f.write("x")
            os.unlink(test)
            return os.path.join(base, "ray_tpu_torch_store", session_name)
        except OSError:
            continue
    return os.path.join(RAY_TPU_TORCH_TMP, "ray_tpu_torch_store", session_name)


def new_session_dir() -> str:
    name = f"session_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
    path = os.path.join(RAY_TPU_TORCH_TMP, name)
    os.makedirs(os.path.join(path, "sockets"), exist_ok=True)
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    return path


def detect_resources(num_cpus=None, num_gpus=None, resources=None, memory=None) -> Dict[str, float]:
    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    if num_gpus is not None:
        out["GPU"] = float(num_gpus)
    else:
        from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

        n = GPUAcceleratorManager.get_current_node_num_accelerators()
        if n:
            out["GPU"] = float(n)
            out.update(GPUAcceleratorManager.get_current_node_additional_resources())
    if memory is not None:
        out["memory"] = float(memory)
    else:
        try:
            total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
            out["memory"] = float(int(total * 0.7))
        except (ValueError, OSError):
            pass
    return out


class NodeProcesses:
    """Driver-side handles to the processes this driver started."""

    def __init__(
        self,
        session_dir: str,
        gcs_address: str,
        raylet_address: str,
        procs,
        store_root: Optional[str] = None,
    ):
        self.session_dir = session_dir
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.procs = list(procs)
        # Recorded at startup — default_store_root() re-probes /dev/shm
        # writability, which can pick a *different* base at teardown.
        self.store_root = store_root

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 5
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                except OSError:
                    pass
        try:
            if os.path.exists(CLUSTER_ADDRESS_FILE):
                with open(CLUSTER_ADDRESS_FILE) as f:
                    if f.read().strip() == self.gcs_address:
                        os.unlink(CLUSTER_ADDRESS_FILE)
        except OSError:
            pass
        # Raylets reclaim their own shm arenas on graceful stop, but a
        # SIGKILL'd raylet can't — sweep this session's store root so
        # /dev/shm doesn't accumulate arenas across runs.
        if self.store_root:
            import shutil

            shutil.rmtree(self.store_root, ignore_errors=True)


def start_head(
    num_cpus=None,
    num_gpus=None,
    resources=None,
    memory=None,
    session_dir: Optional[str] = None,
    wait: bool = True,
    owner_pid: Optional[int] = None,
) -> NodeProcesses:
    session_dir = session_dir or new_session_dir()
    session_name = os.path.basename(session_dir)
    gcs_address = f"unix:{session_dir}/sockets/gcs.sock"
    raylet_address = f"unix:{session_dir}/sockets/raylet_head.sock"
    store_dir = os.path.join(default_store_root(session_name), "head")
    res = detect_resources(num_cpus, num_gpus, resources, memory)
    log = open(os.path.join(session_dir, "logs", "head.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.head_main",
            "--session-dir", session_dir,
            "--gcs-address", gcs_address,
            "--raylet-address", raylet_address,
            "--store-dir", store_dir,
            "--resources", json.dumps(res),
            "--config", CONFIG.dump(),
            "--owner-pid", str(os.getpid() if owner_pid is None else owner_pid),
        ],
        stdout=log,
        stderr=subprocess.STDOUT,
        start_new_session=True,
        env=child_env(),
    )
    log.close()
    node = NodeProcesses(
        session_dir,
        gcs_address,
        raylet_address,
        [proc],
        store_root=os.path.dirname(store_dir),
    )
    if wait:
        _wait_for_node(gcs_address, proc)
        os.makedirs(RAY_TPU_TORCH_TMP, exist_ok=True)
        with open(CLUSTER_ADDRESS_FILE, "w") as f:
            f.write(gcs_address)
    return node


def start_worker_node(
    gcs_address: str,
    session_dir: str,
    num_cpus=None,
    num_gpus=None,
    resources=None,
    memory=None,
    labels=None,
    wait: bool = True,
    owner_pid: Optional[int] = None,
):
    node_tag = uuid.uuid4().hex[:8]
    raylet_address = f"unix:{session_dir}/sockets/raylet_{node_tag}.sock"
    session_name = os.path.basename(session_dir)
    store_dir = os.path.join(default_store_root(session_name), node_tag)
    res = detect_resources(num_cpus, num_gpus, resources, memory)
    log = open(os.path.join(session_dir, "logs", f"raylet_{node_tag}.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.raylet_main",
            "--session-dir", session_dir,
            "--gcs-address", gcs_address,
            "--raylet-address", raylet_address,
            "--store-dir", store_dir,
            "--resources", json.dumps(res),
            "--config", CONFIG.dump(),
            "--owner-pid", str(os.getpid() if owner_pid is None else owner_pid),
            "--labels", json.dumps(labels or {}),
        ],
        stdout=log,
        stderr=subprocess.STDOUT,
        start_new_session=True,
        env=child_env(),
    )
    log.close()
    if wait:
        _wait_for_raylet(gcs_address, raylet_address, proc)
    return proc, raylet_address


def _wait_for_node(gcs_address: str, proc, timeout: float = 30.0):
    from ray_tpu_torch._private import retry

    bo = retry.POLL.start(deadline_s=timeout)
    last_err = None
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"head process exited with code {proc.returncode}; see session logs")
        try:
            client = rpc.RpcClient(gcs_address)
            try:
                info = client.call("get_cluster_info", timeout=5)
                if info["nodes"]:
                    return
            finally:
                client.close()
        except rpc.RpcError as e:
            last_err = e
        delay = bo.next_delay()
        if delay is None:
            raise TimeoutError(f"cluster did not come up within {timeout}s: {last_err}")
        time.sleep(delay)


def _wait_for_raylet(gcs_address: str, raylet_address: str, proc, timeout: float = 30.0):
    from ray_tpu_torch._private import retry

    bo = retry.POLL.start(deadline_s=timeout)
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"raylet process exited with code {proc.returncode}")
        try:
            client = rpc.RpcClient(gcs_address)
            try:
                info = client.call("get_cluster_info", timeout=5)
                for n in info["nodes"].values():
                    if n["raylet_address"] == raylet_address and n["state"] == "ALIVE":
                        return
            finally:
                client.close()
        except rpc.RpcError:
            pass
        delay = bo.next_delay()
        if delay is None:
            raise TimeoutError("worker node did not register in time")
        time.sleep(delay)


def head_raylet_address(gcs_address: str) -> str:
    client = rpc.RpcClient(gcs_address)
    try:
        info = client.call("get_cluster_info")
        heads = [n for n in info["nodes"].values() if n["state"] == "ALIVE" and n.get("is_head")]
        nodes = heads or [n for n in info["nodes"].values() if n["state"] == "ALIVE"]
        if not nodes:
            raise RuntimeError("no alive nodes in cluster")
        return nodes[0]["raylet_address"]
    finally:
        client.close()


async def owner_watchdog(owner_pid: int, stop_event):
    """Tear the cluster down if its owner process dies without a clean
    shutdown (SIGKILL skips atexit).  Shared by head_main/raylet_main;
    callers must hold a strong reference to the task.  owner_pid <= 0
    means detached (`ray-tpu-torch start`): no watchdog."""
    import asyncio

    if owner_pid <= 0:
        return
    while True:
        await asyncio.sleep(2)
        try:
            os.kill(owner_pid, 0)
        except OSError:
            stop_event.set()
            return
