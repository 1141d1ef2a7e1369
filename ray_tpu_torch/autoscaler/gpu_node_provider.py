"""GPU-slice NodeProvider (reference: autoscaler node_provider.py:13 +
autoscaler/_private/gcp/node_provider.py; the counterpart of the JAX
package's ``autoscaler/tpu_node_provider.py``; the resource naming follows
``_private/accelerators/gpu.py``).

One provider "node" is one GPU SLICE (e.g. h100-16 = 2 hosts × 8 cards):
a slice is bought and freed as a unit — you create and delete whole
slices, never individual hosts, so that a gang never holds half a slice.
The provider therefore launches and terminates per-slice, and advertises
slice-topology resources ("GPU": cards, "GPU-<type>": cards,
"GPU-<type>-head": 1, "gpu-slice:<name>": 1) so demand like
{"GPU-h100-16-head": 1} (one request per slice, the reference's
multi-host gang pattern) drives scaling.

The cloud API is injectable: ``provider_config["gpu_client"]`` takes any
object with create/delete/get/list; the default ``GceGpuClient`` speaks
the real ``compute.googleapis.com`` v1 instances surface, one instance a
host (requires credentials + egress), and ``MockGpuClient`` simulates
slice lifecycle for tests and ``--dry-run`` — optionally backing each
READY slice with a local raylet process carrying the slice's resources
so the full demand→create→register→idle→delete loop runs hermetically."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.accelerators.gpu import (
    METADATA_ACCELERATOR_TYPE,
    METADATA_SLICE_NAME,
    METADATA_SLICE_WORKER_INDEX,
)
from ray_tpu_torch.autoscaler.node_provider import TAG_NODE_STATUS, NodeProvider

# accelerator type -> (cards per host, hosts, GCE machine type) for A3
# slices (extend as needed)
SLICE_SHAPES = {
    "h100-1": (1, 1, "a3-highgpu-1g"),
    "h100-4": (4, 1, "a3-highgpu-4g"),
    "h100-8": (8, 1, "a3-highgpu-8g"),
    "h100-16": (8, 2, "a3-highgpu-8g"),
    "h100-32": (8, 4, "a3-highgpu-8g"),
}

#: the label every host instance of a slice carries, valued the slice name
SLICE_LABEL = "ray-tpu-torch-slice"


def _unknown(accelerator_type: str) -> ValueError:
    return ValueError(
        f"unknown accelerator_type {accelerator_type!r}; add its "
        f"(cards_per_host, hosts, machine_type) to SLICE_SHAPES ({sorted(SLICE_SHAPES)})"
    )


def slice_resources(accelerator_type: str, slice_name: str) -> Dict[str, float]:
    """The resource set one slice registers with the cluster (summed
    over its hosts; the head resource appears exactly once).  Unknown
    types raise: silently guessing a shape would let the autoscaler
    bin-pack against the wrong card count while billing real slices."""
    if accelerator_type not in SLICE_SHAPES:
        raise _unknown(accelerator_type)
    cards_per_host, hosts, _machine = SLICE_SHAPES[accelerator_type]
    total = float(cards_per_host * hosts)
    return {
        "GPU": total,
        f"GPU-{accelerator_type}": total,
        f"GPU-{accelerator_type}-head": 1.0,
        f"gpu-slice:{slice_name}": 1.0,
    }


class MockGpuClient:
    """Simulated slice API with the TPU client's dict shape: slices go
    CREATING → READY after ``ready_after_s`` and disappear on delete."""

    def __init__(self, ready_after_s: float = 0.0):
        self.ready_after_s = ready_after_s
        self._slices: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def create(self, name: str, accelerator_type: str, **kwargs) -> dict:
        with self._lock:
            self._slices[name] = {
                "name": name,
                "acceleratorType": accelerator_type,
                "state": "CREATING",
                "createTime": time.monotonic(),
                "networkEndpoints": [],
            }
        return dict(self._slices[name])

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            s = self._slices.get(name)
            if s is None:
                return None
            if (
                s["state"] == "CREATING"
                and time.monotonic() - s["createTime"] >= self.ready_after_s
            ):
                s["state"] = "READY"
                _cards, hosts, _machine = SLICE_SHAPES.get(s["acceleratorType"], (1, 1, ""))
                s["networkEndpoints"] = [
                    {"ipAddress": f"10.0.{len(self._slices)}.{i}"} for i in range(hosts)
                ]
            return dict(s)

    def list(self) -> List[dict]:
        with self._lock:
            names = list(self._slices)
        # a concurrent delete between snapshot and get yields None
        return [s for s in (self.get(n) for n in names) if s is not None]

    def delete(self, name: str) -> None:
        with self._lock:
            self._slices.pop(name, None)


def _urllib_transport(method: str, url: str, headers: Dict[str, str],
                      body: Optional[bytes]) -> dict:
    import json
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read() or b"{}")


class GceGpuClient:
    """Real compute.googleapis.com v1 client: a slice is one instance a
    host, named ``<slice>-<i>`` and labelled with the slice's name
    (insert, get, list by label and delete on projects.zones.instances).
    It hands the provider the TPU client's dict shape — ``state`` READY
    once every host is RUNNING, ``networkEndpoints`` in worker order — so
    the provider's body stays the reference's.  Needs application-default
    credentials and network egress — neither exists in CI, so this path
    is exercised only against real GCP projects (its requests are tested
    through an injected ``transport``).

    Where each request's fields come from (Compute Engine API v1):

    - insert, get, delete:
      https://cloud.google.com/compute/docs/reference/rest/v1/instances/insert
      (and ``.../instances/get``, ``.../instances/delete``); the body's
      fields (``name``, ``machineType`` as ``zones/<zone>/machineTypes/<t>``,
      ``scheduling.onHostMaintenance``, ``labels``, ``metadata.items`` of
      ``{key, value}``, ``disks``, ``networkInterfaces[].network``, and the
      answer's ``status`` and ``networkInterfaces[].networkIP``) are those
      of the instance resource,
      https://cloud.google.com/compute/docs/reference/rest/v1/instances
    - list: https://cloud.google.com/compute/docs/reference/rest/v1/instances/list
      (its ``filter``: ``labels.<key>=<value>``, and ``labels.<key>:*`` for
      "carries the label"; the answer's ``items``)
    - the A3 machine types of ``SLICE_SHAPES``:
      https://cloud.google.com/compute/docs/accelerator-optimized-machines
    - ``onHostMaintenance: TERMINATE``: a VM with GPUs cannot live-migrate
      (https://cloud.google.com/compute/docs/gpus, its restrictions)

    The boot disk is the deployment's choice (an image with the NVIDIA
    driver): ``create_args`` must give ``disks``, and this client names no
    image of its own."""

    API = "https://compute.googleapis.com/compute/v1"

    def __init__(self, project: str, zone: str, token_provider=None, transport=None):
        self.zone = zone
        self.parent = f"projects/{project}/zones/{zone}"
        self._token_provider = token_provider or self._adc_token
        # transport(method, url, headers, body bytes or None) -> JSON dict;
        # raises urllib.error.HTTPError on an HTTP error status
        self._transport = transport or _urllib_transport

    @staticmethod
    def _adc_token() -> str:
        import subprocess

        out = subprocess.run(
            ["gcloud", "auth", "application-default", "print-access-token"],
            capture_output=True, text=True, timeout=30,
        )
        if out.returncode != 0:
            raise RuntimeError(f"no GCP credentials: {out.stderr.strip()}")
        return out.stdout.strip()

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        import json

        return self._transport(
            method,
            f"{self.API}/{path}",
            {
                "Authorization": f"Bearer {self._token_provider()}",
                "Content-Type": "application/json",
            },
            None if body is None else json.dumps(body).encode(),
        )

    def _list_hosts(self, slice_name: Optional[str] = None) -> List[dict]:
        import urllib.parse

        flt = f"labels.{SLICE_LABEL}={slice_name}" if slice_name else f"labels.{SLICE_LABEL}:*"
        return self._request(
            "GET", f"{self.parent}/instances?filter={urllib.parse.quote(flt)}"
        ).get("items", [])

    @staticmethod
    def _metadata(instance: dict) -> Dict[str, str]:
        return {i.get("key"): i.get("value")
                for i in (instance.get("metadata") or {}).get("items", [])}

    def _slice_view(self, name: str, hosts: List[dict]) -> dict:
        """The TPU client's dict for one slice from its host instances."""
        by_index = {}
        for inst in hosts:
            index = self._metadata(inst).get(METADATA_SLICE_WORKER_INDEX)
            by_index[int(index or 0)] = inst
        accel = self._metadata(hosts[0]).get(METADATA_ACCELERATOR_TYPE, "")
        _cards, n_hosts, _machine = SLICE_SHAPES.get(accel, (0, len(hosts), ""))
        ordered = [by_index.get(i) for i in range(n_hosts)]
        ready = all(inst is not None and inst.get("status") == "RUNNING" for inst in ordered)
        return {
            "name": name,
            "acceleratorType": accel,
            "state": "READY" if ready else "CREATING",
            "networkEndpoints": [
                {"ipAddress": ((inst.get("networkInterfaces") or [{}])[0]).get("networkIP")}
                for inst in ordered if inst is not None
            ] if ready else [],
        }

    def create(self, name: str, accelerator_type: str, **kwargs) -> dict:
        if accelerator_type not in SLICE_SHAPES:
            raise _unknown(accelerator_type)
        if "disks" not in kwargs:
            raise ValueError(
                "GceGpuClient.create needs the boot disk in the node config's "
                "create_args['disks'] (an image with the NVIDIA driver)"
            )
        _cards, hosts, machine = SLICE_SHAPES[accelerator_type]
        out = []
        for i in range(hosts):
            body = {
                "name": f"{name}-{i}",
                "machineType": f"zones/{self.zone}/machineTypes/{machine}",
                # GPU VMs cannot live-migrate: the API refuses MIGRATE
                "scheduling": {"onHostMaintenance": "TERMINATE"},
                "labels": {SLICE_LABEL: name},
                # what _private/accelerators/gpu.py reads on the host
                "metadata": {"items": [
                    {"key": METADATA_ACCELERATOR_TYPE, "value": accelerator_type},
                    {"key": METADATA_SLICE_NAME, "value": name},
                    {"key": METADATA_SLICE_WORKER_INDEX, "value": str(i)},
                ]},
                "networkInterfaces": [{"network": "global/networks/default"}],
            }
            body.update(kwargs)  # disks, networkInterfaces, reservationAffinity, ...
            out.append(self._request("POST", f"{self.parent}/instances", body))
        return {"name": name, "acceleratorType": accelerator_type, "operations": out}

    def get(self, name: str) -> Optional[dict]:
        import urllib.error

        try:
            head = self._request("GET", f"{self.parent}/instances/{name}-0")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None  # the one case that truly means "gone"
            raise  # auth/5xx must surface, not masquerade as deletion
        accel = self._metadata(head).get(METADATA_ACCELERATOR_TYPE, "")
        hosts = [head]
        if SLICE_SHAPES.get(accel, (0, 1, ""))[1] > 1:
            hosts = self._list_hosts(name) or hosts
        return self._slice_view(name, hosts)

    def list(self) -> List[dict]:
        groups: Dict[str, List[dict]] = {}
        for inst in self._list_hosts():
            groups.setdefault((inst.get("labels") or {}).get(SLICE_LABEL, ""), []).append(inst)
        return [self._slice_view(name, hosts) for name, hosts in groups.items() if name]

    def delete(self, name: str) -> None:
        import urllib.error

        for inst in self._list_hosts(name):
            try:
                self._request("DELETE", f"{self.parent}/instances/{inst['name']}")
            except urllib.error.HTTPError as e:
                if e.code != 404:  # already gone is what delete wants
                    raise


class GPUNodeProvider(NodeProvider):
    """Slice-granular provider.  provider_config keys:

    - ``gpu_client``: injectable API client (default: GceGpuClient built
      from ``project``/``zone``; tests pass MockGpuClient)
    - ``launch_local_raylets``: back each READY slice with a local
      raylet process advertising the slice's resources (dry-run /
      hermetic e2e; needs ``gcs_address`` + ``session_dir``)
    """

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str = "gpu"):
        super().__init__(provider_config, cluster_name)
        self.client = provider_config.get("gpu_client") or GceGpuClient(
            provider_config["project"], provider_config["zone"]
        )
        self.launch_local = bool(provider_config.get("launch_local_raylets"))
        self.gcs_address = provider_config.get("gcs_address")
        self.session_dir = provider_config.get("session_dir")
        # per-host bootstrap (reference: _private/command_runner.py +
        # updater.py): when setup/start commands are configured, a READY
        # slice's hosts each get a NodeUpdater run before the slice is
        # marked up-to-date.  The runner factory is injectable (tests
        # record commands; default is ssh).
        self.initialization_commands = list(provider_config.get("initialization_commands", []))
        self.setup_commands = list(provider_config.get("setup_commands", []))
        self.start_ray_commands = list(provider_config.get("start_ray_commands", []))
        self._runner_factory = provider_config.get("command_runner_factory")
        self._ssh_user = provider_config.get("ssh_user", "ray")
        self._ssh_key = provider_config.get("ssh_private_key")
        self._nodes: Dict[str, dict] = {}  # slice name -> record
        self._lock = threading.Lock()

    def _make_runner(self, ip: str):
        if self._runner_factory is not None:
            return self._runner_factory(ip)
        from ray_tpu_torch.autoscaler.command_runner import SSHCommandRunner

        return SSHCommandRunner(ip, user=self._ssh_user, ssh_key=self._ssh_key)

    @property
    def _has_bootstrap_commands(self) -> bool:
        return bool(self.initialization_commands or self.setup_commands
                    or self.start_ray_commands)

    def _bootstrap_slice(self, node_id: str) -> bool:
        """Run the configured command phases on EVERY host of the slice,
        hosts CONCURRENTLY (slices are multi-host; each worker VM needs
        its own bootstrap — reference: updater.py runs one NodeUpdater
        per node in its own thread).  Returns success."""
        if not self._has_bootstrap_commands:
            return True
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.autoscaler.command_runner import NodeUpdater

        s = self.client.get(node_id) or {}
        ips = [e.get("ipAddress") for e in s.get("networkEndpoints", [])]
        env = {
            "RAY_TPU_TORCH_GCS_ADDRESS": self.gcs_address or "",
            "RAY_TPU_TORCH_SLICE_NAME": node_id,
            "RAY_TPU_TORCH_ACCELERATOR_TYPE": s.get("acceleratorType", ""),
        }

        def one_host(item) -> bool:
            worker_index, ip = item
            if not ip:
                return True
            updater = NodeUpdater(
                self._make_runner(ip),
                initialization_commands=self.initialization_commands,
                setup_commands=self.setup_commands,
                start_ray_commands=self.start_ray_commands,
                env=dict(env, RAY_TPU_TORCH_SLICE_WORKER_INDEX=str(worker_index)),
            )
            try:
                updater.update()
                return True
            except Exception as e:  # noqa: BLE001 — ssh timeouts,
                # network errors etc. must mark the host failed, not
                # escape and wedge the slice in 'pending' forever
                import logging

                logging.getLogger(__name__).warning(
                    "slice %s host %s bootstrap failed: %s", node_id, ip, e
                )
                return False

        with ThreadPoolExecutor(max_workers=min(16, max(1, len(ips)))) as pool:
            return all(pool.map(one_host, enumerate(ips)))

    # -- NodeProvider interface -----------------------------------------
    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        self._reconcile_local_backing()
        with self._lock:
            return [
                nid
                for nid, rec in self._nodes.items()
                if rec["tags"].get(TAG_NODE_STATUS) != "terminated"
                and all(rec["tags"].get(k) == v for k, v in tag_filters.items())
            ]

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def create_node(self, node_config, tags, count):
        accel = node_config.get("accelerator_type", "h100-8")
        if accel not in SLICE_SHAPES:
            # fail BEFORE creating a billed slice that later reconcile
            # passes couldn't size (slice_resources raises on unknowns)
            raise ValueError(
                f"unknown accelerator_type {accel!r}; known: {sorted(SLICE_SHAPES)}"
            )
        created = []
        for _ in range(count):
            name = f"{self.cluster_name}-{accel}-{uuid.uuid4().hex[:6]}"
            self.client.create(name, accel, **node_config.get("create_args", {}))
            rec = {
                "accelerator_type": accel,
                "tags": dict(tags, **{TAG_NODE_STATUS: "pending"}),
                "proc": None,
                "raylet_address": None,
            }
            with self._lock:
                self._nodes[name] = rec
            created.append(name)
        return created

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            rec = self._nodes.get(node_id)
            if rec is None:
                return
            rec["tags"][TAG_NODE_STATUS] = "terminated"
        self.client.delete(node_id)
        proc = rec.get("proc")
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:
                proc.kill()

    def is_running(self, node_id: str) -> bool:
        s = self.client.get(node_id)
        return s is not None and s.get("state") == "READY"

    def internal_ip(self, node_id: str) -> Optional[str]:
        s = self.client.get(node_id)
        eps = (s or {}).get("networkEndpoints") or []
        return eps[0].get("ipAddress") if eps else None

    def raylet_address(self, node_id: str) -> Optional[str]:
        with self._lock:
            rec = self._nodes.get(node_id)
        return rec["raylet_address"] if rec else None

    # -- dry-run backing -------------------------------------------------
    def _reconcile_local_backing(self):
        """In launch_local_raylets mode, a slice reaching READY gets one
        local raylet carrying the whole slice's resource set (the test
        stand-in for the per-host bootstrap a real deployment runs via
        its VM startup script)."""
        if not self.launch_local:
            # promote pending → up-to-date on READY, running the per-host
            # bootstrap first when commands are configured.  Bootstraps
            # run in a DAEMON THREAD per slice (hosts concurrent inside),
            # never inline: one slow host must not stall the autoscaler
            # tick that called non_terminated_nodes (reference: updater
            # threads in autoscaler.py).
            with self._lock:
                candidates = [
                    (nid, rec) for nid, rec in self._nodes.items()
                    if rec["tags"].get(TAG_NODE_STATUS) == "pending"
                    and not rec.get("bootstrapping")
                ]
            # cheap READY pre-filter OUTSIDE the lock: a slice mid-
            # provisioning must not spawn a thread per tick just to find
            # it isn't running yet
            ready = [(nid, rec) for nid, rec in candidates if self.is_running(nid)]
            with self._lock:
                # claim inside ONE lock acquisition: two concurrent
                # reconcile callers must not both start a bootstrap for
                # one slice (double `ray start` per host)
                claimed = []
                for nid, rec in ready:
                    if (rec["tags"].get(TAG_NODE_STATUS) == "pending"
                            and not rec.get("bootstrapping")):
                        rec["bootstrapping"] = True
                        claimed.append((nid, rec))
            for nid, rec in claimed:
                def run_bootstrap(nid=nid, rec=rec):
                    try:
                        ok = (not self._has_bootstrap_commands
                              or self._bootstrap_slice(nid))
                        final = "up-to-date" if ok else "update-failed"
                    except Exception:  # noqa: BLE001 — never wedge 'pending'
                        final = "update-failed"
                    with self._lock:
                        rec["bootstrapping"] = False
                        rec["tags"][TAG_NODE_STATUS] = final

                t = threading.Thread(
                    target=run_bootstrap, daemon=True,
                    name=f"slice-bootstrap-{nid}",
                )
                rec["bootstrap_thread"] = t
                t.start()
            return
        from ray_tpu_torch._private.node import start_worker_node

        with self._lock:
            pending = [
                (nid, rec) for nid, rec in self._nodes.items()
                if rec["tags"].get(TAG_NODE_STATUS) == "pending"
            ]
        for nid, rec in pending:
            if not self.is_running(nid):
                continue
            res = slice_resources(rec["accelerator_type"], nid)
            proc, raylet_addr = start_worker_node(
                self.gcs_address,
                self.session_dir,
                num_cpus=4,
                # Port: the slice's own card count.  Left unset, the node
                # would count this machine's cards (_private/node.py:
                # detect_resources) and overwrite the slice's GPU.
                num_gpus=res.pop("GPU"),
                resources=res,
                wait=True,
            )
            with self._lock:
                rec["proc"] = proc
                rec["raylet_address"] = raylet_addr
                rec["tags"][TAG_NODE_STATUS] = "up-to-date"

