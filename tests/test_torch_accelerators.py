"""The card's type and slice resources, and the GPU-slice node provider.

Parity with the JAX package: the GPU provider's ``slice_resources`` has the
TPU provider's key structure and totals for slices of equal shape (cards
per host, hosts), a card host's additional resources have a TPU host's
form, and the two providers, each over its mock client, walk the same node
statuses and bootstrap the same number of hosts.  Then the port's own
checks: detection reads the card's model name, honours
``CUDA_VISIBLE_DEVICES``, imports no torch, reads the slice identity, and
queries GCE metadata only on a GCE VM; ``GceGpuClient``'s requests go
through an injected transport and never reach the network.
"""

import io
import json
import os
import subprocess
import sys
import time
import urllib.error

import pytest

from ray_tpu_torch._private import retry
from ray_tpu_torch._private.accelerators import gpu as gpu_accel
from ray_tpu_torch._private.accelerators import get_accelerator_manager
from ray_tpu_torch.autoscaler import gpu_node_provider as gpu_prov

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H100_INFO = ("Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:   \t\t 42\n"
             "GPU UUID: \t GPU-00000000-0000-0000-0000-000000000000\nDevice Minor: \t 0\n")


@pytest.fixture(autouse=True)
def _no_slice_env(monkeypatch, tmp_path):
    """No slice identity, no visible-device mask, and a machine that is
    not a GCE VM, whatever the host running the tests is."""
    for name in (gpu_accel.ACCELERATOR_TYPE_ENV, gpu_accel.SLICE_NAME_ENV,
                 gpu_accel.SLICE_WORKER_INDEX_ENV, gpu_accel.SKIP_METADATA_ENV,
                 gpu_accel.CUDA_VISIBLE_DEVICES_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(gpu_accel, "DMI_PRODUCT_NAME", str(tmp_path / "no_dmi"))

    def no_network(key, timeout=0.5):
        raise AssertionError(f"metadata query for {key} off GCE")

    monkeypatch.setattr(gpu_accel, "_query_gce_metadata", no_network)
    gpu_accel._gce_slice_identity.cache_clear()
    gpu_accel._cards.cache_clear()
    yield
    gpu_accel._gce_slice_identity.cache_clear()
    gpu_accel._cards.cache_clear()


def _card_host(tmp_path, cards=4, model="NVIDIA H100 80GB HBM3"):
    """A /dev with ``cards`` card files (and the control files beside
    them) and a driver directory with one ``information`` file a card."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(cards):
        (dev / f"nvidia{i}").touch()
    for name in ("nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    proc = tmp_path / "gpus"
    for i in range(cards):
        d = proc / f"0000:{i:02x}:00.0"
        d.mkdir(parents=True)
        name = model[i] if isinstance(model, (list, tuple)) else model
        (d / "information").write_text(H100_INFO.replace("NVIDIA H100 80GB HBM3", name)
                                       .replace("0000-000000000000", f"0000-00000000000{i}")
                                       .replace("Minor: \t 0", f"Minor: \t {i}"))
    return str(dev), str(proc)


def _neutral(res, accel, kind):
    """A slice's resource keys with its accelerator word and type taken
    out, so a TPU and a GPU resource set compare."""
    out = {}
    for key, value in res.items():
        key = key.replace(accel, "<type>")
        key = key.replace(f"{kind}-", "ACC-").replace(f"{kind.lower()}-slice:", "acc-slice:")
        out["ACC" if key == kind else key] = value
    return out


# ------------------------------------------------------------ parity with the JAX package


def test_slice_resources_match_the_tpu_providers_for_equal_shapes():
    from ray_tpu.autoscaler import tpu_node_provider as tpu_prov

    pairs = [(t, g) for t, tshape in tpu_prov.SLICE_SHAPES.items()
             for g, gshape in gpu_prov.SLICE_SHAPES.items() if tshape == gshape[:2]]
    assert {g for _, g in pairs} >= {"h100-4", "h100-8"}
    for tpu_type, gpu_type in pairs:
        tpu = tpu_prov.slice_resources(tpu_type, "s")
        gpu = gpu_prov.slice_resources(gpu_type, "s")
        assert _neutral(tpu, tpu_type, "TPU") == _neutral(gpu, gpu_type, "GPU")
        assert tpu["TPU"] == gpu["GPU"] == gpu[f"GPU-{gpu_type}"]
    for bad in ("v5litepod-16", "h100-3"):
        with pytest.raises(ValueError, match="unknown accelerator_type"):
            gpu_prov.slice_resources(bad, "s")


def test_node_additional_resources_have_the_tpu_managers_form(tmp_path, monkeypatch):
    from ray_tpu._private.accelerators.tpu import TPUAcceleratorManager

    monkeypatch.setenv("TPU_CHIPS_PER_HOST", "4")
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "v5litepod-4")
    monkeypatch.setenv("RAY_TPU_SKIP_METADATA", "1")
    monkeypatch.setattr(TPUAcceleratorManager, "_cached", None)
    try:
        tpu = TPUAcceleratorManager.get_current_node_additional_resources()
        tpu_type = TPUAcceleratorManager.get_current_node_accelerator_type()
        tpu_count = TPUAcceleratorManager.get_current_node_num_accelerators()
    finally:
        TPUAcceleratorManager._cached = None
    dev, proc = _card_host(tmp_path, 4)
    G = gpu_accel.GPUAcceleratorManager
    gpu = G.get_current_node_additional_resources(dev, proc)
    assert gpu == {"GPU-h100-4": 4.0, "GPU-h100-4-head": 1.0}
    assert _neutral(tpu, tpu_type, "TPU") == _neutral(gpu, "h100-4", "GPU")
    assert tpu_count == G.get_current_node_num_accelerators(dev) == 4
    assert G.get_resource_name() == "GPU"
    assert get_accelerator_manager("GPU") is G and get_accelerator_manager("TPU") is None


class _Runner:
    def __init__(self, ip, ran, fail=False):
        self.ip, self.ran, self.fail = ip, ran, fail

    def run(self, cmd, *, timeout=600.0):
        self.ran.append(self.ip)
        if self.fail:
            raise RuntimeError("boom")
        return ""


def _walk(provider_cls, client_cls, client_key, accel):
    """Node statuses a provider goes through: create, reconcile without
    bootstrap, reconcile with a bootstrap that succeeds and one that
    fails, terminate; and the hosts each bootstrap ran on."""
    from ray_tpu_torch.autoscaler.node_provider import TAG_NODE_STATUS

    statuses, hosts = [], []

    def settle(provider, nid):
        bo = retry.POLL.start(deadline_s=30)
        while provider.node_tags(nid)[TAG_NODE_STATUS] == "pending":
            delay = bo.next_delay()
            if delay is None:
                break
            provider.non_terminated_nodes({})
            time.sleep(delay)
        return provider.node_tags(nid)[TAG_NODE_STATUS]

    for commands, fail in (([], False), (["x"], False), (["x"], True)):
        ran = []
        provider = provider_cls({client_key: client_cls(), "setup_commands": commands,
                                 "command_runner_factory":
                                     lambda ip, ran=ran, fail=fail: _Runner(ip, ran, fail)},
                                "walk")
        (nid,) = provider.create_node({"accelerator_type": accel}, {"node-kind": "worker"}, 1)
        statuses.append(provider.node_tags(nid)[TAG_NODE_STATUS])
        provider.non_terminated_nodes({})
        statuses.append(settle(provider, nid))
        provider.terminate_node(nid)
        statuses.append(provider.node_tags(nid)[TAG_NODE_STATUS])
        statuses.append(provider.non_terminated_nodes({}))
        statuses.append(provider.client.get(nid))
        hosts.append(len(set(ran)))
    return statuses, hosts


def test_providers_walk_the_same_node_statuses_and_bootstrap_the_same_hosts():
    from ray_tpu.autoscaler import MockTpuClient, TPUNodeProvider

    tpu = _walk(TPUNodeProvider, MockTpuClient, "tpu_client", "v5litepod-16")
    gpu = _walk(gpu_prov.GPUNodeProvider, gpu_prov.MockGpuClient, "gpu_client", "h100-32")
    assert tpu[0] == gpu[0]
    statuses, hosts = gpu
    assert statuses[:5] == ["pending", "up-to-date", "terminated", [], None]
    assert statuses[6] == "up-to-date" and statuses[11] == "update-failed"
    # a failing host ends its slice's bootstrap: hosts not yet started are
    # cancelled in both (the count that ran is a race there)
    assert tpu[1][:2] == hosts[:2] == [0, 4]
    assert tpu[1][2] >= 1 and hosts[2] >= 1


# ------------------------------------------------------------ the port's detection


_DETECT = r"""
import json, os, sys
from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager as G
dev, proc = sys.argv[1], sys.argv[2]
out = {}
for v in (None, "1", "2,0"):
    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    if v is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = v
    out[repr(v)] = [G.get_current_node_num_accelerators(dev),
                    G.get_current_node_accelerator_type(dev, proc),
                    G.get_current_node_additional_resources(dev, proc)]
out["torch"] = "torch" in sys.modules
print(json.dumps(out))
"""


def test_detection_reads_the_model_name_and_honours_visible_devices(tmp_path):
    """In a clean process: the type is the model word and the visible
    cards; detecting imports no torch."""
    dev, proc = _card_host(tmp_path, 4)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, RAY_TPU_TORCH_SKIP_METADATA="1")
    for name in (gpu_accel.ACCELERATOR_TYPE_ENV, gpu_accel.SLICE_NAME_ENV,
                 gpu_accel.SLICE_WORKER_INDEX_ENV):
        env.pop(name, None)
    res = subprocess.run([sys.executable, "-c", _DETECT, dev, proc], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=60, env=env)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {
        "None": [4, "h100-4", {"GPU-h100-4": 4.0, "GPU-h100-4-head": 1.0}],
        "'1'": [1, "h100-1", {"GPU-h100-1": 1.0, "GPU-h100-1-head": 1.0}],
        "'2,0'": [2, "h100-2", {"GPU-h100-2": 2.0, "GPU-h100-2-head": 1.0}],
        "torch": False,
    }


@pytest.mark.parametrize("name, family", [
    ("NVIDIA H100 80GB HBM3", "h100"),
    ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA A100-SXM4-80GB", "a100"),
    ("Tesla V100-SXM2-16GB", "v100"),
    ("NVIDIA GeForce RTX 4090", "rtx4090"),
    ("NVIDIA L4", "l4"),
    ("NVIDIA", "gpu"),
])
def test_family_is_the_lower_cased_model_word(name, family):
    assert gpu_accel.family_of(name) == family


def test_model_name_falls_back_to_nvidia_smi(tmp_path, monkeypatch):
    dev, _proc = _card_host(tmp_path, 1)
    calls = []

    def fake_run(argv, **kwargs):
        calls.append(argv)
        return subprocess.CompletedProcess(
            argv, 0, "GPU-5f1c0a2e-0000-0000-0000-000000000000, NVIDIA H100 80GB HBM3\n", "")

    monkeypatch.setattr(gpu_accel.subprocess, "run", fake_run)
    G = gpu_accel.GPUAcceleratorManager
    assert G.get_current_node_accelerator_type(dev, str(tmp_path / "absent")) == "h100-1"
    assert calls == [["nvidia-smi", "--query-gpu=uuid,name", "--format=csv,noheader"]]
    # the names are cached: a second node start in this process asks again for nothing
    assert G.get_current_node_additional_resources(dev, str(tmp_path / "absent")) == {
        "GPU-h100-1": 1.0, "GPU-h100-1-head": 1.0}
    assert len(calls) == 1
    # no card: nothing is asked
    calls.clear()
    gpu_accel._cards.cache_clear()
    assert G.get_current_node_accelerator_type(str(tmp_path), str(tmp_path / "absent")) is None
    assert calls == []


@pytest.mark.parametrize("source", ["information", "nvidia-smi"])
def test_type_names_the_first_visible_card(tmp_path, monkeypatch, source):
    """On a host whose cards differ, the type's family is that of the first
    card of ``CUDA_VISIBLE_DEVICES`` (by index or by UUID prefix), not the
    host's first card."""
    models = ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 80GB HBM3"]
    dev, proc = _card_host(tmp_path, 2, model=models)
    if source == "nvidia-smi":
        proc = str(tmp_path / "absent")
        out = "".join(f"GPU-00000000-0000-0000-0000-00000000000{i}, {m}\n"
                      for i, m in enumerate(models))
        monkeypatch.setattr(gpu_accel.subprocess, "run", lambda argv, **kw:
                            subprocess.CompletedProcess(argv, 0, out, ""))
    G = gpu_accel.GPUAcceleratorManager
    for visible, accel in ((None, "a100-2"), ("1", "h100-1"), ("1,0", "h100-2"),
                           ("GPU-00000000-0000-0000-0000-000000000001", "h100-1"),
                           ("GPU-00000000-0000-0000-0000-00000000000", "a100-1"),
                           ("7", "a100-1")):
        if visible is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert G.get_current_node_accelerator_type(dev, proc) == accel, visible


def test_slice_identity_gives_type_head_slice_and_pod(tmp_path, monkeypatch):
    """The provider's bootstrap exports the slice identity: it names the
    type, and only worker 0 carries the head resource."""
    dev, proc = _card_host(tmp_path, 8)
    G = gpu_accel.GPUAcceleratorManager
    monkeypatch.setenv(gpu_accel.ACCELERATOR_TYPE_ENV, "h100-16")
    monkeypatch.setenv(gpu_accel.SLICE_NAME_ENV, "gpu-h100-16-abc123")
    monkeypatch.setenv(gpu_accel.SLICE_WORKER_INDEX_ENV, "0")
    assert G.get_current_node_additional_resources(dev, proc) == {
        "GPU-h100-16": 8.0, "GPU-h100-16-head": 1.0, "gpu-slice:gpu-h100-16-abc123": 1.0}
    assert G.get_current_pod_name(dev) == "gpu-h100-16-abc123"
    assert G.get_current_pod_worker_count(dev) == 2
    monkeypatch.setenv(gpu_accel.SLICE_WORKER_INDEX_ENV, "1")
    assert G.get_current_node_additional_resources(dev, proc) == {
        "GPU-h100-16": 8.0, "gpu-slice:gpu-h100-16-abc123": 1.0}
    # no card on the host: no card resources, whatever the identity says
    assert G.get_current_node_additional_resources(str(tmp_path), proc) == {}


def test_visible_devices_setter_and_getter(monkeypatch):
    G = gpu_accel.GPUAcceleratorManager
    assert G.get_current_process_visible_accelerator_ids() is None
    G.set_current_process_visible_accelerators([2, 0])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,0"
    assert G.get_current_process_visible_accelerator_ids() == ["2", "0"]


def test_metadata_is_queried_only_on_gce(tmp_path, monkeypatch):
    dev, proc = _card_host(tmp_path, 8)
    G = gpu_accel.GPUAcceleratorManager
    # off GCE (the fixture's no_network query fails the test if asked)
    dmi = tmp_path / "product_name"
    dmi.write_text("Standard PC (Q35 + ICH9, 2009)\n")
    monkeypatch.setattr(gpu_accel, "DMI_PRODUCT_NAME", str(dmi))
    assert G.get_current_node_accelerator_type(dev, proc) == "h100-8"
    # on GCE, the attributes GceGpuClient set (answered here, no network)
    dmi.write_text("Google Compute Engine\n")
    asked = []
    attrs = {gpu_accel.METADATA_ACCELERATOR_TYPE: "h100-16",
             gpu_accel.METADATA_SLICE_NAME: "s1",
             gpu_accel.METADATA_SLICE_WORKER_INDEX: "1"}

    def fake_query(key, timeout=0.5):
        asked.append(key)
        return attrs.get(key)

    monkeypatch.setattr(gpu_accel, "_query_gce_metadata", fake_query)
    assert G.get_current_node_additional_resources(dev, proc) == {
        "GPU-h100-16": 8.0, "gpu-slice:s1": 1.0}
    assert sorted(asked) == sorted(attrs)
    # skipped on request, and never asked without a card
    gpu_accel._gce_slice_identity.cache_clear()
    asked.clear()
    monkeypatch.setenv(gpu_accel.SKIP_METADATA_ENV, "1")
    assert G.get_current_node_accelerator_type(dev, proc) == "h100-8"
    monkeypatch.delenv(gpu_accel.SKIP_METADATA_ENV)
    assert G.get_current_node_accelerator_type(str(tmp_path), proc) is None
    assert asked == []


def test_detect_resources_adds_the_slice_resources_only_when_detecting(tmp_path, monkeypatch):
    from ray_tpu_torch._private import node as node_mod

    dev, proc = _card_host(tmp_path, 2)
    G = gpu_accel.GPUAcceleratorManager
    count, extra = G.get_current_node_num_accelerators, G.get_current_node_additional_resources
    monkeypatch.setattr(G, "get_current_node_num_accelerators",
                        staticmethod(lambda dev_dir="/dev": count(dev)))
    monkeypatch.setattr(G, "get_current_node_additional_resources",
                        staticmethod(lambda dev_dir="/dev", proc_dir=None: extra(dev, proc)))
    res = node_mod.detect_resources(1, None, {}, memory=1)
    assert res == {"CPU": 1.0, "GPU": 2.0, "GPU-h100-2": 2.0, "GPU-h100-2-head": 1.0,
                   "memory": 1.0}
    # num_gpus given (a provider's node): only what it was given
    assert node_mod.detect_resources(1, 1, {"GPU-h100-1": 1.0}, memory=1) == {
        "CPU": 1.0, "GPU": 1.0, "GPU-h100-1": 1.0, "memory": 1.0}


# ------------------------------------------------------------ the provider's cloud client


class _Transport:
    """Records every request and answers from a table of instances."""

    def __init__(self):
        self.calls = []
        self.instances = {}
        self.fail_get = None

    def __call__(self, method, url, headers, body):
        import urllib.parse

        self.calls.append((method, url, json.loads(body) if body else None))
        assert headers["Authorization"] == "Bearer tok"
        path = url[len(gpu_prov.GceGpuClient.API) + 1:]
        assert path.startswith("projects/p/zones/z/instances")
        rest = path[len("projects/p/zones/z/instances"):]
        if method == "POST":
            inst = dict(json.loads(body), status="PROVISIONING",
                        networkInterfaces=[{"networkIP": f"10.1.0.{len(self.instances)}"}])
            self.instances[inst["name"]] = inst
            return {"kind": "compute#operation"}
        if method == "GET" and rest.startswith("?filter="):
            flt = urllib.parse.unquote(rest[len("?filter="):])
            key, _, want = flt.partition("=")
            label = key.split(".", 1)[1].rstrip(":*")
            return {"items": [i for i in self.instances.values()
                              if label in i.get("labels", {})
                              and (not want or i["labels"][label] == want)]}
        name = rest.lstrip("/")
        if method == "GET":
            if self.fail_get is not None:
                raise urllib.error.HTTPError(url, self.fail_get, "err", {}, io.BytesIO())
            if name not in self.instances:
                raise urllib.error.HTTPError(url, 404, "not found", {}, io.BytesIO())
            return self.instances[name]
        if method == "DELETE":
            if self.instances.pop(name, None) is None:
                raise urllib.error.HTTPError(url, 404, "not found", {}, io.BytesIO())
            return {"kind": "compute#operation"}
        raise AssertionError((method, url))


def test_gce_gpu_client_requests_go_through_the_transport():
    t = _Transport()
    client = gpu_prov.GceGpuClient("p", "z", token_provider=lambda: "tok", transport=t)
    disks = [{"boot": True, "autoDelete": True,
              "initializeParams": {"sourceImage": "projects/p/global/images/img"}}]
    # the boot disk is the deployment's: no request is made without it
    with pytest.raises(ValueError, match="create_args\\['disks'\\]"):
        client.create("s0", "h100-1")
    assert t.calls == []
    client.create("s1", "h100-16", labels={gpu_prov.SLICE_LABEL: "s1", "team": "a"},
                  disks=disks)
    posts = [c for c in t.calls if c[0] == "POST"]
    assert [b["name"] for _, _, b in posts] == ["s1-0", "s1-1"]
    for i, (_m, url, body) in enumerate(posts):
        assert url == "https://compute.googleapis.com/compute/v1/projects/p/zones/z/instances"
        assert body["machineType"] == "zones/z/machineTypes/a3-highgpu-8g"
        assert body["scheduling"]["onHostMaintenance"] == "TERMINATE"
        assert body["labels"] == {gpu_prov.SLICE_LABEL: "s1", "team": "a"}  # create_args merged
        assert body["disks"] == disks
        items = {m["key"]: m["value"] for m in body["metadata"]["items"]}
        assert items == {gpu_accel.METADATA_ACCELERATOR_TYPE: "h100-16",
                         gpu_accel.METADATA_SLICE_NAME: "s1",
                         gpu_accel.METADATA_SLICE_WORKER_INDEX: str(i)}
    assert client.get("s1")["state"] == "CREATING"
    t.instances["s1-0"]["status"] = "RUNNING"
    assert client.get("s1")["state"] == "CREATING"  # one host is not a slice
    t.instances["s1-1"]["status"] = "RUNNING"
    view = client.get("s1")
    assert view["state"] == "READY" and view["acceleratorType"] == "h100-16"
    assert view["networkEndpoints"] == [{"ipAddress": "10.1.0.0"}, {"ipAddress": "10.1.0.1"}]
    client.create("s2", "h100-1", disks=disks)
    assert sorted((s["name"], s["state"]) for s in client.list()) == [
        ("s1", "READY"), ("s2", "CREATING")]
    with pytest.raises(ValueError, match="unknown accelerator_type"):
        client.create("s3", "v5litepod-16")
    # a 404 on get means gone; other errors surface
    client.delete("s1")
    assert sorted(t.instances) == ["s2-0"]
    assert [c[1].rsplit("/", 1)[1] for c in t.calls if c[0] == "DELETE"] == ["s1-0", "s1-1"]
    assert client.get("s1") is None
    t.fail_get = 503
    with pytest.raises(urllib.error.HTTPError):
        client.get("s2")


def test_provider_refuses_an_unknown_type_before_creating():
    created = []

    class _Client(gpu_prov.MockGpuClient):
        def create(self, name, accelerator_type, **kwargs):
            created.append(name)
            return super().create(name, accelerator_type, **kwargs)

    provider = gpu_prov.GPUNodeProvider({"gpu_client": _Client()}, "u")
    with pytest.raises(ValueError, match="unknown accelerator_type"):
        provider.create_node({"accelerator_type": "v5litepod-16"}, {}, 1)
    assert created == [] and provider.non_terminated_nodes({}) == []
    provider.create_node({"accelerator_type": "h100-1", "create_args": {"x": 1}}, {}, 1)
    assert len(created) == 1
