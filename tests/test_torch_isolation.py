"""The port stands alone: ray_tpu_torch and chip_smoke.py import neither
JAX nor any module of the JAX package (the machine with the card has no
JAX), and chip_smoke.py refuses to run without a card.  The port's
runtime keeps to its own processes, session root and environment, never
imports torch at module level, and counts the node's GPUs without
touching torch or the card."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_EVERY_MODULE = r"""
import importlib, json, pkgutil, sys
import ray_tpu_torch
names = ["ray_tpu_torch"]
for info in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "ray_tpu")


# The serve control plane: the controller and the HTTP proxy run these,
# and never torch (only a replica whose deployment needs it loads torch).
_SERVE_PLANE_MODULES = (
    "ray_tpu_torch.serve", "ray_tpu_torch.serve.api", "ray_tpu_torch.serve.handle",
    "ray_tpu_torch.serve.batching", "ray_tpu_torch.serve.multiplex",
    "ray_tpu_torch.serve.schema", "ray_tpu_torch.serve._private.common",
    "ray_tpu_torch.serve._private.long_poll", "ray_tpu_torch.serve._private.request_context",
    "ray_tpu_torch.serve._private.router", "ray_tpu_torch.serve._private.replica",
    "ray_tpu_torch.serve._private.controller", "ray_tpu_torch.serve._private.proxy",
    "ray_tpu_torch.serve._private.local_testing_mode", "ray_tpu_torch.serve.llm",
    "ray_tpu_torch.serve.llm.overload",
)


def test_port_imports_no_jax_and_no_ray_tpu():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_EVERY_MODULE],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    for mod in ("ray_tpu_torch.ops.flash_attention", "ray_tpu_torch.models.convert",
                "ray_tpu_torch.models.common", "ray_tpu_torch.serve.llm.engine",
                "ray_tpu_torch.ops._build", "ray_tpu_torch.models.llama",
                "ray_tpu_torch.models.resnet", "ray_tpu_torch.models.vit",
                "ray_tpu_torch.models.mlp", "ray_tpu_torch.models.moe",
                "ray_tpu_torch._private.raylet", "ray_tpu_torch._private.gcs_server",
                "ray_tpu_torch._private.worker", "ray_tpu_torch._native.arena",
                "ray_tpu_torch.train.torch.config", "ray_tpu_torch.train.torch.gpt2_loop",
                "ray_tpu_torch.util.collective.cpu_group",
                *_SERVE_PLANE_MODULES, "ray_tpu_torch.serve.llm.deployment",
                *_TUNE_RLLIB_MODULES):
        assert mod in out["imported"]


_TUNE_RLLIB_MODULES = (
    "ray_tpu_torch.tune", "ray_tpu_torch.tune.tuner", "ray_tpu_torch.tune.tune_controller",
    "ray_tpu_torch.tune.trainable", "ray_tpu_torch.tune.schedulers",
    "ray_tpu_torch.tune.search.tpe", "ray_tpu_torch.tune.search.bohb",
    "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.core.rl_module",
    "ray_tpu_torch.rllib.core.learner", "ray_tpu_torch.rllib.env.env_runner",
    "ray_tpu_torch.rllib.env.env_runner_group", "ray_tpu_torch.rllib.algorithms.algorithm",
    "ray_tpu_torch.rllib.algorithms.ppo", "ray_tpu_torch.rllib.connectors",
    "ray_tpu_torch.rllib.utils.postprocessing",
)


def test_tune_imports_no_torch_and_rllib_imports_without_gymnasium():
    """A trial actor imports Tune (a trainer sweep's trial needs no
    torch); the card machine may lack gymnasium, which RLlib imports only
    where an env is made."""
    code = ("import importlib, json, sys\n"
            "import ray_tpu_torch.tune\n"
            "tune_torch = 'torch' in sys.modules\n"
            "sys.modules['gymnasium'] = None  # an import of it raises\n"
            f"for m in {_TUNE_RLLIB_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps([tune_torch, sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'flax', 'optax', 'ray_tpu'))]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [False, []]


def _imports_in(path: str) -> list:
    """Every absolute module a file imports, at any depth: inside
    functions and methods too, which importing the module never runs."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            imported.append(node.module or "")
    return imported


def test_port_sources_import_no_jax_and_no_ray_tpu_at_any_depth():
    """The import scan above sees only what importing a module runs; this
    reads every source file of the port, so an import inside a function
    (an entry point's lazy ``from ray_tpu import ...``) is caught too."""
    bad, n_files = [], 0
    for root, _dirs, files in os.walk(os.path.join(REPO_ROOT, "ray_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                n_files += 1
                bad += [(os.path.relpath(path, REPO_ROOT), m)
                        for m in _imports_in(path) if _forbidden(m)]
    assert n_files > 90
    assert bad == []


_BUILD_APP = r"""
import json, sys
import ray_tpu_torch.serve
from ray_tpu_torch.serve import llm
apps = {dev: llm.build_app(llm.LLMConfig(model="tiny", device=dev), route_prefix="/llm")
        for dev in ("cpu", "cuda")}
print(json.dumps({
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ray_tpu")),
    "torch": "torch" in sys.modules,
    "application": all(isinstance(a, ray_tpu_torch.serve.Application) for a in apps.values()),
    "deployment": all(isinstance(a.deployment, ray_tpu_torch.serve.Deployment)
                      for a in apps.values()),
    "target": [a.deployment._target is llm.LLMServer for a in apps.values()],
    "actor_options": {d: a.deployment._config.ray_actor_options for d, a in apps.items()},
}))
"""


def test_build_app_stays_in_the_port():
    """``llm.build_app`` in a clean process: the Application and its
    Deployment are the port's, no module of JAX or of the JAX package is
    loaded, and neither is torch (the controller unpickles what it
    builds).  A CUDA engine's replica leases one GPU, a CPU one none."""
    proc = subprocess.run([sys.executable, "-c", _BUILD_APP], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "torch": False, "application": True, "deployment": True,
                   "target": [True, True],
                   "actor_options": {"cpu": {}, "cuda": {"num_gpus": 1}}}


def test_chip_smoke_imports_no_jax_and_no_ray_tpu():
    imported = _imports_in(os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert "torch" in imported
    assert any(m.startswith("ray_tpu_torch") for m in imported)
    assert [m for m in imported if _forbidden(m)] == []


def test_chip_smoke_fails_without_a_card():
    """On a machine without CUDA it exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


_RUNTIME_MODULES = (
    "ray_tpu_torch", "ray_tpu_torch.train", "ray_tpu_torch.train.torch",
    "ray_tpu_torch.air", "ray_tpu_torch.util.collective", "ray_tpu_torch.cluster_utils",
    "ray_tpu_torch._private.head_main", "ray_tpu_torch._private.raylet_main",
    "ray_tpu_torch._private.gcs_main", "ray_tpu_torch._private.default_worker",
    "ray_tpu_torch._private.profiling", "ray_tpu_torch._private.serialization",
    "ray_tpu_torch._private.accelerators.gpu",
)


def test_runtime_modules_do_not_import_torch():
    """The raylet, the GCS and every pooled worker import these: none of
    them imports torch at module level."""
    code = ("import importlib, json, sys\n"
            f"for m in {_RUNTIME_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_serve_control_plane_imports_no_torch():
    """A clean process imports the serve package, its control-plane
    modules and ``serve.llm.overload`` (which the proxy and the request
    context reach through ``serve.llm``) without torch; the deployment
    module too, since the controller unpickles ``LLMServer`` and its
    config.  Asking ``serve.llm`` for the engine is what loads torch."""
    code = ("import importlib, json, sys\n"
            f"for m in {_SERVE_PLANE_MODULES!r} + ('ray_tpu_torch.serve.llm.deployment',):\n"
            "    importlib.import_module(m)\n"
            "before = sorted(m for m in sys.modules if m.split('.')[0] == 'torch')\n"
            "from ray_tpu_torch.serve import llm\n"
            "llm.LLMEngine\n"
            "print(json.dumps([before, 'torch' in sys.modules]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], True]


# The channels, the DAG API and the serve dataplane: the proxy decodes
# every token frame, and the controller, the proxy and pooled workers run
# these, so none of them may load torch (or anything of JAX).
_CHANNEL_MODULES = (
    "ray_tpu_torch._private.wire", "ray_tpu_torch.experimental.channel",
    "ray_tpu_torch.dag", "ray_tpu_torch.serve._private.dataplane",
    "ray_tpu_torch.serve._private.grpc_proxy",
)


def test_channel_and_dataplane_modules_import_no_torch_jax_or_ray_tpu():
    code = ("import importlib, json, sys\n"
            f"for m in {_CHANNEL_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
            "                        & {'torch', 'jax', 'jaxlib', 'flax', 'ray_tpu'})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_ACTOR_PROBE = r"""
import json, os, sys
import ray_tpu_torch

ctx = ray_tpu_torch.init(num_cpus=2)

@ray_tpu_torch.remote
class Probe:
    def report(self):
        return {"modules": sorted(sys.modules),
                "env": sorted(k for k in os.environ if k.startswith("RAY_TPU")),
                "argv": sys.argv}

try:
    out = ray_tpu_torch.get(Probe.remote().report.remote(), timeout=120)
    out["session_dir"] = ctx["session_dir"]
    out["driver_modules"] = sorted(sys.modules)
finally:
    ray_tpu_torch.shutdown()
print(json.dumps(out))
"""


def test_port_actor_runs_port_modules_under_its_own_root_and_prefix(tmp_path):
    """A port actor's process holds neither JAX nor any module of the JAX
    package, runs the port's worker entry point, and sees only the port's
    environment prefix; the session lives under the port's own root in
    the caller's temp dir, so programs with temp dirs of their own never
    share a cluster-address file."""
    probe_tmp = tempfile.mkdtemp(prefix="rtt_")
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU")}
    env.update(PYTHONPATH=REPO_ROOT, TMPDIR=probe_tmp)
    env["RAY_TPU_TORCH_arena_prefault_bytes"] = "0"  # no 2 GiB shm prefault
    env["RAY_TPU_TORCH_memory_monitor_enabled"] = "0"  # the machine is shared
    try:
        proc = subprocess.run([sys.executable, "-c", _ACTOR_PROBE], cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=180)
    finally:
        shutil.rmtree(probe_tmp, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mods in (out["modules"], out["driver_modules"]):
        assert [m for m in mods if _forbidden(m)] == []
        assert [m for m in mods if m.split(".")[0] == "torch"] == []
    assert "ray_tpu_torch._private.default_worker" in out["modules"] or any(
        "ray_tpu_torch/_private/default_worker" in a for a in out["argv"])
    assert out["env"] and all(k.startswith("RAY_TPU_TORCH_") for k in out["env"]), out["env"]
    root = os.path.join(probe_tmp, "ray_tpu_torch")
    if len(root) > 42:  # a temp dir too long for socket paths: the keyed short root
        root = "/tmp/ray_tpu_torch_" + hashlib.sha1(root.encode()).hexdigest()[:12]
    assert out["session_dir"].startswith(root + "/session_"), out["session_dir"]


def test_session_root_follows_the_temp_dir(monkeypatch):
    """The root is ``<temp dir>/ray_tpu_torch``; a temp dir too long for a
    unix socket path gets a short root keyed by that dir, one per dir."""
    from ray_tpu_torch._private import node

    monkeypatch.setattr(tempfile, "tempdir", "/tmp/a")
    assert node._default_root() == "/tmp/a/ray_tpu_torch"
    roots = set()
    for d in ("/tmp/" + "x" * 40, "/tmp/" + "y" * 40):
        monkeypatch.setattr(tempfile, "tempdir", d)
        root = node._default_root()
        assert root.startswith("/tmp/ray_tpu_torch_") and len(root) <= node._MAX_ROOT_LEN
        roots.add(root)
    assert len(roots) == 2
    # a worker's direct-push socket is the longest path under the root
    longest = (f"{'r' * node._MAX_ROOT_LEN}/session_20261017_034437_abcdef12"
               f"/sockets/w_{'0' * 16}.sock")
    assert len(longest) <= 107


def test_gpu_detection_counts_device_files_and_honours_visible_devices(tmp_path):
    """GPU detection counts /dev/nvidia<N> (not nvidiactl or nvidia-uvm),
    restricted to as many cards as CUDA_VISIBLE_DEVICES has entries, and
    imports no torch."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidia1", "nvidia2", "nvidiactl", "nvidia-uvm", "nvidia-modeset"):
        (dev / name).touch()
    code = ("import json, os, sys\n"
            "from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager as G\n"
            "out = {}\n"
            "for v in (None, '1', '2,0', '', '0,1,2,3', 'GPU-aa,GPU-bb'):\n"
            "    os.environ.pop('CUDA_VISIBLE_DEVICES', None)\n"
            "    if v is not None: os.environ['CUDA_VISIBLE_DEVICES'] = v\n"
            f"    out[repr(v)] = G.get_current_node_num_accelerators({str(dev)!r})\n"
            "out['torch'] = 'torch' in sys.modules\n"
            "print(json.dumps(out))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=60, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"None": 3, "'1'": 1, "'2,0'": 2, "''": 0, "'0,1,2,3'": 3,
                   "'GPU-aa,GPU-bb'": 2, "torch": False}


def test_gpu_detection_skips_device_files_it_cannot_open(tmp_path, monkeypatch):
    """A container can show the device file of a card its cgroup does not
    let it use: such a file does not count."""
    from ray_tpu_torch._private.accelerators.gpu import GPUAcceleratorManager

    for name in ("nvidia0", "nvidia1"):
        (tmp_path / name).touch()
    real_open = os.open

    def deny_nvidia1(path, flags, *args):
        if os.path.basename(path) == "nvidia1":
            raise PermissionError(1, "Operation not permitted", path)
        return real_open(path, flags, *args)

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert GPUAcceleratorManager.get_current_node_num_accelerators(str(tmp_path)) == 2
    monkeypatch.setattr(os, "open", deny_nvidia1)
    assert GPUAcceleratorManager.get_current_node_num_accelerators(str(tmp_path)) == 1
    (tmp_path / "nvidia0").unlink()
    assert GPUAcceleratorManager.get_current_node_num_accelerators(str(tmp_path)) == 0


def test_data_modules_import_no_torch():
    """Read and map tasks run in pooled workers, which import the data
    modules: none of them imports torch at module level."""
    code = ("import importlib, json, pkgutil, sys\n"
            "import ray_tpu_torch.data as d\n"
            "names = [i.name for i in pkgutil.walk_packages(d.__path__, 'ray_tpu_torch.data.')]\n"
            "for m in names: importlib.import_module(m)\n"
            "print(json.dumps([len(names), sorted(m for m in sys.modules\n"
            "                                  if m.split('.')[0] == 'torch')]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr
    n, torch_mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert n >= 11 and torch_mods == []


_DATA_PROBE = r"""
import json, os, sys
import numpy as np
import ray_tpu_torch
import ray_tpu_torch.data as rd

root = sys.argv[1]
for i in range(4):
    np.save(os.path.join(root, f"tokens_{i}.npy"), np.full((8, 5), i, np.int32))
ray_tpu_torch.init(num_cpus=2)
try:
    def tag(batch):
        return {**batch, "torch": np.full(len(batch["data"]), "torch" in sys.modules)}

    its = rd.read_numpy(root).map_batches(tag).streaming_split(2, equal=True)
    rows = [b for it in its for b in it.iter_batches(batch_size=None, prefetch_batches=0)]

    def descendants(root_pid):
        kids = {}
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except OSError:
                continue
            kids.setdefault(ppid, []).append(int(pid))
        out, todo = [], [root_pid]
        while todo:
            for k in kids.get(todo.pop(), []):
                out.append(k)
                todo.append(k)
        return out

    maps = {}
    for pid in descendants(os.getpid()):
        try:
            with open(f"/proc/{pid}/maps") as f:
                maps[pid] = "libtorch" in f.read()
        except OSError:
            pass
    out = {"rows": int(sum(len(b["data"]) for b in rows)),
           "task_saw_torch": sorted({bool(x) for b in rows for x in b["torch"]}),
           "processes": len(maps), "with_libtorch": [p for p, hit in maps.items() if hit],
           "driver_torch": "torch" in sys.modules}
finally:
    ray_tpu_torch.shutdown()
print(json.dumps(out))
"""


def test_data_task_workers_import_no_torch(tmp_path):
    """A read, a map and a streaming_split run in the port's workers
    without torch: the map task reports its process's modules, and no
    process of the cluster maps libtorch."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    env["RAY_TPU_TORCH_arena_prefault_bytes"] = "0"  # no 2 GiB shm prefault
    env["RAY_TPU_TORCH_memory_monitor_enabled"] = "0"  # the machine is shared
    proc = subprocess.run([sys.executable, "-c", _DATA_PROBE, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rows"] == 32 and out["task_saw_torch"] == [False]
    assert out["processes"] >= 2 and out["with_libtorch"] == []
    assert out["driver_torch"] is False
