"""Runtime environments on the port (a copy of the JAX package's
tests/test_runtime_env.py; it imports neither JAX nor the JAX package):
working_dir / py_modules / env_vars / pip.

Reference behavior being matched: python/ray/_private/runtime_env/
{working_dir.py,pip.py,uri_cache.py} + runtime-env agent error surfacing
(RuntimeEnvSetupError on staging failure).
"""

import os
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import runtime_env as renv
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module", autouse=True)
def _cluster_settings():
    """Every cluster of this module (the module's and the job-level test's
    own) runs without the 2 GiB shm arena prefault and without the memory
    monitor: the suite runs many clusters at once, and the monitor
    watches the whole machine.  pip, which the workers run for a ``pip``
    spec, looks at no package index: the one wheel here is built
    locally."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_arena_prefault_bytes", "0")
        mp.setenv("RAY_TPU_TORCH_memory_monitor_enabled", "0")
        mp.setenv("PIP_NO_INDEX", "1")
        yield


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2, resources={"remote_node": 1})
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


@pytest.fixture()
def pkg_dir(tmp_path):
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "re_mod_for_test.py").write_text("VALUE = 777\n")
    (d / "data.txt").write_text("data-content")
    sub = d / "sub"
    sub.mkdir()
    (sub / "extra.txt").write_text("extra")
    return str(d)


def test_job_level_runtime_env():
    """runtime_env passed to init() applies to every task of the job.
    Runs FIRST: it owns its own single-node cluster, and must finish
    before the module-scoped multi-node cluster fixture connects."""
    ray_tpu_torch.init(num_cpus=2, runtime_env={"env_vars": {"RE_JOB_VAR": "job"}})
    try:

        @ray_tpu_torch.remote
        def t():
            return os.environ.get("RE_JOB_VAR")

        assert ray_tpu_torch.get(t.remote(), timeout=60) == "job"
    finally:
        ray_tpu_torch.shutdown()


def test_env_vars_applied_and_isolated(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RE_TEST_VAR": "v1"}})
    def with_env():
        return os.environ.get("RE_TEST_VAR"), os.getpid()

    @ray_tpu_torch.remote
    def without_env():
        return os.environ.get("RE_TEST_VAR"), os.getpid()

    val, pid1 = ray_tpu_torch.get(with_env.remote(), timeout=60)
    other, pid2 = ray_tpu_torch.get(without_env.remote(), timeout=60)
    assert val == "v1"
    assert other is None
    # Different envs must not share worker processes.
    assert pid1 != pid2


def test_same_env_reuses_worker(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RE_REUSE": "x"}})
    def t():
        return os.getpid()

    pids = {ray_tpu_torch.get(t.remote(), timeout=60) for _ in range(5)}
    # Sequential tasks with one identical env reuse the same staged worker.
    assert len(pids) == 1


def test_working_dir_ships_cross_node(cluster, pkg_dir):
    """The working_dir is zipped on the driver, stored in the GCS KV, and
    staged on a node the driver never touched."""

    @ray_tpu_torch.remote(resources={"remote_node": 0.1}, runtime_env={"working_dir": pkg_dir})
    def use_wd():
        import re_mod_for_test

        return (
            re_mod_for_test.VALUE,
            open("data.txt").read(),
            open(os.path.join("sub", "extra.txt")).read(),
            os.path.basename(os.getcwd()),
        )

    value, data, extra, cwd = ray_tpu_torch.get(use_wd.remote(), timeout=60)
    assert value == 777
    assert data == "data-content"
    assert extra == "extra"
    assert len(cwd) == 40  # staged under the content sha1


def test_working_dir_on_actor(cluster, pkg_dir):
    @ray_tpu_torch.remote(runtime_env={"working_dir": pkg_dir})
    class A:
        def read(self):
            import re_mod_for_test

            return re_mod_for_test.VALUE

    a = A.remote()
    assert ray_tpu_torch.get(a.read.remote(), timeout=60) == 777
    ray_tpu_torch.kill(a)


def test_py_modules(cluster, tmp_path):
    # Reference semantics: each py_modules entry is the package directory
    # itself and becomes importable by its own name on the worker.
    pkg = tmp_path / "mods" / "re_pkg_for_test"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("NAME = 're_pkg'\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(pkg)]})
    def use_mod():
        import re_pkg_for_test

        # py_modules must NOT chdir (only working_dir does).
        return re_pkg_for_test.NAME, os.getcwd()

    name, cwd = ray_tpu_torch.get(use_mod.remote(), timeout=60)
    assert name == "re_pkg"
    assert "runtime_resources" not in cwd


def test_staging_failure_raises_runtime_env_setup_error(cluster):
    """A package URI missing from the GCS KV fails staging on the worker;
    the error must surface as RuntimeEnvSetupError, not a hang or a
    worker spawn loop."""
    bogus = {"working_dir": renv.URI_PREFIX + "0" * 40 + ".zip"}

    @ray_tpu_torch.remote(runtime_env=bogus, max_retries=0)
    def t():
        return 1

    with pytest.raises(ray_tpu_torch.exceptions.RuntimeEnvSetupError):
        ray_tpu_torch.get(t.remote(), timeout=60)


def test_pip_local_wheel(cluster, tmp_path):
    """pip specs install into a --target dir on the worker's sys.path.
    Offline-safe: installs a hand-built wheel by absolute path."""
    name, version = "re_wheel_pkg", "0.1.0"
    whl = tmp_path / f"{name}-{version}-py3-none-any.whl"
    dist = f"{name}-{version}.dist-info"
    meta = f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n"
    wheel_meta = "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true\nTag: py3-none-any\n"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}.py", "MAGIC = 12321\n")
        zf.writestr(f"{dist}/METADATA", meta)
        zf.writestr(f"{dist}/WHEEL", wheel_meta)
        zf.writestr(f"{dist}/RECORD", "")

    @ray_tpu_torch.remote(runtime_env={"pip": [str(whl)]})
    def use_wheel():
        import re_wheel_pkg

        return re_wheel_pkg.MAGIC

    assert ray_tpu_torch.get(use_wheel.remote(), timeout=120) == 12321


def test_nested_task_inherits_parent_env(cluster):
    """A subtask submitted from inside a task inherits the parent worker's
    runtime env (reference parent-inheritance semantics)."""

    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RE_NEST": "inherited"}})
    def parent():
        @ray_tpu_torch.remote
        def child():
            return os.environ.get("RE_NEST")

        return ray_tpu_torch.get(child.remote(), timeout=30)

    assert ray_tpu_torch.get(parent.remote(), timeout=60) == "inherited"


def test_prepare_hash_stability(tmp_path):
    d = tmp_path / "p"
    d.mkdir()
    (d / "a.py").write_text("x = 1\n")
    n1, u1 = renv.prepare({"working_dir": str(d)})
    n2, u2 = renv.prepare({"working_dir": str(d)})
    assert n1 == n2 and u1[0][0] == u2[0][0]
    # Content change changes the URI.
    (d / "a.py").write_text("x = 2\n")
    n3, _ = renv.prepare({"working_dir": str(d)})
    assert n3["working_dir"] != n1["working_dir"]
    # env merging: task overrides job, env_vars union.
    job = {"env_vars": {"A": "1", "B": "1"}, "working_dir": "gcs://_runtime_envs/x.zip"}
    task = {"env_vars": {"B": "2"}}
    merged = renv.merge(job, task)
    assert merged["env_vars"] == {"A": "1", "B": "2"}
    assert merged["working_dir"] == job["working_dir"]
    assert renv.env_hash(None) == "" and renv.env_hash(merged) != ""
