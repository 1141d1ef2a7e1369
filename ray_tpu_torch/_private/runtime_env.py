"""Runtime environments: working_dir / py_modules / env_vars / pip.

Reference: python/ray/_private/runtime_env/{working_dir.py,pip.py,
uri_cache.py} and the per-node agent (runtime_env/agent/main.py).

Design here (tpu-idiomatic compression of the same contract):

- The *driver* normalizes a runtime_env at decoration/init time:
  local ``working_dir`` / ``py_modules`` directories are zipped,
  content-hashed, and uploaded once to the GCS KV store under
  ``gcs://_runtime_envs/<sha>.zip`` — the cluster-wide content store the
  reference keeps in its GCS too (working_dir.py upload_package_if_needed).
- The raylet keys its idle-worker pool by (job, env-hash) and passes the
  serialized env to spawned workers via ``RAY_TPU_TORCH_RUNTIME_ENV``.
- The *worker* self-stages before registering: downloads + unzips under a
  cross-process file lock into ``<session>/runtime_resources/<sha>/``
  (so staging happens once per node, like the reference's per-node
  runtime-env agent, but without a separate daemon), installs pip specs
  with ``pip install --target`` into a cached dir, prepends staged dirs
  to ``sys.path``, chdirs into the working_dir, and applies ``env_vars``.
  Staging failures are reported to the raylet at registration and fail
  the requesting tasks with RuntimeEnvSetupError instead of spawn-looping.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import subprocess
import sys
import zipfile
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

KV_NS = b"fun:_runtime_envs"  # GCS KV namespace for uploaded packages
URI_PREFIX = "gcs://_runtime_envs/"

SUPPORTED_KEYS = {
    "working_dir", "py_modules", "env_vars", "pip", "config",
    "conda", "uv", "image_uri",
}


# ----------------------------------------------------------------------
# plugin API (reference: _private/runtime_env/plugin.py RuntimeEnvPlugin)
# ----------------------------------------------------------------------
class RuntimeEnvPlugin:
    """Pluggable runtime_env field handler.  ``name`` is the env dict
    key the plugin owns; ``validate`` runs driver-side at prepare time,
    ``stage`` runs in the worker before task execution and may mutate
    the process (sys.path, os.environ, cwd)."""

    name: str = ""
    priority: int = 10  # lower stages first

    def validate(self, value) -> None:
        pass

    def stage(self, value, gcs_client, session_dir: str) -> None:
        raise NotImplementedError


_plugins: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise RuntimeEnvError("plugin must set a name")
    _plugins[plugin.name] = plugin
    SUPPORTED_KEYS.add(plugin.name)


class CondaPlugin(RuntimeEnvPlugin):
    """``conda``: named env or spec dict (reference: runtime_env/conda.py).
    Gated: requires a conda binary on the node — absent here, staging
    raises RuntimeEnvError rather than half-working."""

    name = "conda"

    def validate(self, value) -> None:
        if not isinstance(value, (str, dict)):
            raise RuntimeEnvError("runtime_env['conda'] must be an env name or spec dict")

    def stage(self, value, gcs_client, session_dir: str) -> None:
        import shutil

        if shutil.which("conda") is None:
            raise RuntimeEnvError(
                "runtime_env['conda'] requires a conda installation on the node"
            )
        import subprocess as sp

        if isinstance(value, str):
            env_name = value
        else:
            env_name = value.get("name", "ray-tpu-env")
            spec_path = os.path.join(session_dir, f"conda-{env_hash(value)}.yml")
            with open(spec_path, "w") as f:
                json.dump(value, f)
            sp.run(["conda", "env", "update", "-n", env_name, "-f", spec_path],
                   check=True, capture_output=True, timeout=1800)
        # ask the ENV's interpreter for its own site-packages (its
        # python version need not match this worker's)
        out = sp.run(
            ["conda", "run", "-n", env_name, "python", "-c",
             "import site, sys; print(sys.prefix); print(site.getsitepackages()[0])"],
            check=True, capture_output=True, text=True, timeout=120,
        )
        prefix, site_dir = out.stdout.strip().splitlines()[-2:]
        os.sys.path.insert(0, site_dir)
        os.environ["CONDA_PREFIX"] = prefix


class UvPlugin(RuntimeEnvPlugin):
    """``uv``: list of specs installed via the uv resolver (reference:
    runtime_env/uv.py); falls back to RuntimeEnvError when uv is absent
    (use ``pip`` instead on this image)."""

    name = "uv"

    def validate(self, value) -> None:
        if not (isinstance(value, list) and all(isinstance(p, str) for p in value)):
            raise RuntimeEnvError("runtime_env['uv'] must be a List[str] of specs")

    def stage(self, value, gcs_client, session_dir: str) -> None:
        import shutil

        if shutil.which("uv") is None:
            raise RuntimeEnvError(
                "runtime_env['uv'] requires the uv binary; use 'pip' on this image"
            )
        target = os.path.join(_resources_dir(session_dir), f"uv-{env_hash(value)}")
        marker = os.path.join(target, ".ray_tpu_complete")
        if not os.path.exists(marker):
            # once-per-node staging under the cross-process lock (same
            # protocol as _stage_pip)
            with _FileLock(target + ".lock"):
                if not os.path.exists(marker):
                    import subprocess as sp

                    sp.run(["uv", "pip", "install", "--target", target] + list(value),
                           check=True, capture_output=True, timeout=600)
                    with open(marker, "w") as f:
                        f.write("ok")
        os.sys.path.insert(0, target)


class ImageUriPlugin(RuntimeEnvPlugin):
    """``image_uri``: per-task container images (reference:
    runtime_env/image_uri.py).  Worker processes here run directly on
    the host — container isolation needs a container runtime the image
    doesn't ship, so this is validate-only + explicit failure."""

    name = "image_uri"

    def validate(self, value) -> None:
        if not isinstance(value, str):
            raise RuntimeEnvError("runtime_env['image_uri'] must be a string")

    def stage(self, value, gcs_client, session_dir: str) -> None:
        raise RuntimeEnvError(
            "runtime_env['image_uri'] needs a container runtime (podman/docker), "
            "which this deployment does not provide"
        )


for _p in (CondaPlugin(), UvPlugin(), ImageUriPlugin()):
    _plugins[_p.name] = _p

# Dirs never worth shipping (reference: working_dir.py excludes .git etc.
# via upload filters; __pycache__ differs per interpreter run).
DEFAULT_EXCLUDES = {"__pycache__", ".git", ".venv", "node_modules"}


class RuntimeEnvError(ValueError):
    pass


# ----------------------------------------------------------------------
# normalization (driver side)
# ----------------------------------------------------------------------
def validate(env: dict) -> None:
    unknown = set(env) - SUPPORTED_KEYS
    if unknown:
        raise RuntimeEnvError(
            f"Unsupported runtime_env keys {sorted(unknown)}; "
            f"supported: {sorted(SUPPORTED_KEYS)}"
        )
    ev = env.get("env_vars")
    if ev is not None and not (
        isinstance(ev, dict)
        and all(isinstance(k, str) and isinstance(v, str) for k, v in ev.items())
    ):
        raise RuntimeEnvError("runtime_env['env_vars'] must be a Dict[str, str]")
    pip = env.get("pip")
    if pip is not None and not (
        isinstance(pip, list) and all(isinstance(p, str) for p in pip)
    ):
        raise RuntimeEnvError("runtime_env['pip'] must be a List[str] of pip specs")
    for key, plugin in _plugins.items():
        if key in env:
            plugin.validate(env[key])


def prepare(env: Optional[dict]) -> Tuple[Optional[dict], List[Tuple[str, bytes]]]:
    """Normalize an env without touching the network.

    Local directories become content-addressed ``gcs://`` URIs; the
    returned ``uploads`` list of (uri, zip_bytes) must be pushed to the
    GCS KV (see :func:`finish_uploads`) before any task using the env is
    submitted.  Separating the two lets ``ray_tpu_torch.init`` hash the
    working_dir before it is connected to a cluster.
    """
    if not env:
        return (None, [])
    validate(env)
    norm: dict = {}
    uploads: List[Tuple[str, bytes]] = []
    wd = env.get("working_dir")
    if wd:
        norm["working_dir"], blob = _to_uri(wd)
        if blob is not None:
            uploads.append((norm["working_dir"], blob))
    mods = env.get("py_modules")
    if mods:
        out = []
        for m in mods:
            # A py_modules entry is the package directory itself: zip it
            # WITH its top-level name so the staged dir is a sys.path
            # root from which ``import <basename>`` works (reference:
            # packaging.py include_parent_dir=True for py_modules).
            uri, blob = _to_uri(m, include_parent=True)
            out.append(uri)
            if blob is not None:
                uploads.append((uri, blob))
        norm["py_modules"] = out
    if env.get("env_vars"):
        norm["env_vars"] = dict(env["env_vars"])
    if env.get("pip"):
        norm["pip"] = sorted(env["pip"])
    if env.get("config"):
        norm["config"] = dict(env["config"])
    for key in _plugins:
        if key in env:
            norm[key] = env[key]
    return (norm or None, uploads)


def _to_uri(path_or_uri: str, include_parent: bool = False) -> Tuple[str, Optional[bytes]]:
    if path_or_uri.startswith(URI_PREFIX):
        return path_or_uri, None
    if not os.path.isdir(path_or_uri):
        raise RuntimeEnvError(
            f"runtime_env working_dir/py_modules entry {path_or_uri!r} is not "
            f"a local directory or {URI_PREFIX} URI"
        )
    blob = _zip_dir(path_or_uri, include_parent=include_parent)
    limit = 200 * 1024 * 1024
    if len(blob) > limit:
        raise RuntimeEnvError(
            f"runtime_env package {path_or_uri!r} is {len(blob)/1e6:.0f} MB "
            f"zipped; the limit is {limit/1e6:.0f} MB"
        )
    sha = hashlib.sha1(blob).hexdigest()
    return f"{URI_PREFIX}{sha}.zip", blob


def _zip_dir(path: str, include_parent: bool = False) -> bytes:
    """Deterministic zip (sorted names, zeroed timestamps) so equal trees
    hash equal across hosts and runs.  With ``include_parent`` entries are
    prefixed with the directory's own name (py_modules semantics)."""
    buf = io.BytesIO()
    prefix = os.path.basename(os.path.normpath(path)) if include_parent else ""
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in DEFAULT_EXCLUDES)
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            full = os.path.join(root, f)
            rel = os.path.relpath(full, path)
            entries.append((os.path.join(prefix, rel) if prefix else rel, full))
    entries.sort()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            with open(full, "rb") as fh:
                zf.writestr(info, fh.read())
    return buf.getvalue()


def finish_uploads(gcs_client, uploads: List[Tuple[str, bytes]]) -> None:
    """Idempotently push packaged dirs into the GCS KV."""
    for uri, blob in uploads:
        key = uri[len(URI_PREFIX):].encode()
        if not gcs_client.call("kv_exists", (KV_NS, key)):
            gcs_client.call("kv_put", (KV_NS, key, blob, False))


def normalize_uploaded(raw: Optional[dict], upload_fn) -> dict:
    """prepare() + upload in one step: the single normalization sequence
    shared by the in-cluster driver (uploads straight to the GCS KV) and
    the ray:// client (uploads via the client server), so env semantics
    can't silently diverge between the two.  Returns {} for an empty env
    (cacheable sentinel)."""
    prepared, uploads = prepare(raw)
    for uri, blob in uploads:
        upload_fn(uri, blob)
    return prepared or {}


def merge(job_env: Optional[dict], task_env: Optional[dict]) -> Optional[dict]:
    """Task env overrides the job env per-field; env_vars are merged with
    the task's winning (reference: runtime_env.py build_proto_runtime_env
    parent/child override semantics)."""
    if not job_env:
        return task_env or None
    if not task_env:
        return job_env or None
    out = dict(job_env)
    for k, v in task_env.items():
        if k == "env_vars":
            out["env_vars"] = {**job_env.get("env_vars", {}), **v}
        else:
            out[k] = v
    return out


def env_hash(env: Optional[dict]) -> str:
    """Stable identity for worker-pool keying ('' = default env)."""
    if not env:
        return ""
    return hashlib.sha1(
        json.dumps(env, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]


def spec_env_hash(spec) -> str:
    """Cached env hash for a TaskSpec."""
    h = getattr(spec, "_env_hash", None)
    if h is None:
        h = env_hash(spec.runtime_env)
        try:
            spec._env_hash = h
        except Exception:
            pass
    return h


# ----------------------------------------------------------------------
# staging (worker side)
# ----------------------------------------------------------------------
class _FileLock:
    """fcntl flock wrapper; staging must be once-per-node even when many
    workers of the same env spawn concurrently."""

    def __init__(self, path: str):
        self._path = path
        self._f = None

    def __enter__(self):
        import fcntl

        os.makedirs(os.path.dirname(self._path), exist_ok=True)
        self._f = open(self._path, "a+")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl

        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def _resources_dir(session_dir: str) -> str:
    return os.path.join(session_dir, "runtime_resources")


def _fetch_package(gcs_client, uri: str, dest_dir: str, session_dir: str) -> str:
    """Download + unzip a gcs:// package into the cache; returns the
    staged directory.  Cached by content hash (uri), so a hit is free
    (reference: uri_cache.py)."""
    name = uri[len(URI_PREFIX):]
    final = os.path.join(dest_dir, name[:-4])  # strip .zip
    if os.path.isdir(final):
        return final
    with _FileLock(os.path.join(dest_dir, name + ".lock")):
        if os.path.isdir(final):
            return final
        # A prestarted worker can boot before the driver's upload lands
        # in the KV (connect_driver triggers prestart, finish_uploads
        # runs just after): retry for a short window before declaring
        # the package missing.
        import time as _time

        from ray_tpu_torch._private import retry as _retry

        from ray_tpu_torch._private import rpc as _rpc

        bo = _retry.KV_STAGING.start(deadline_s=15)
        while True:
            # Large package blobs: 60s per attempt is sizing, not slack —
            # GCS_READ_BULK allows one retry so the worst case stays near
            # the pre-retry budget.
            blob = _rpc.call_idempotent(
                gcs_client, "kv_get", (KV_NS, name.encode()), timeout=60,
                policy=_retry.GCS_READ_BULK,
            )
            if blob is not None:
                break
            delay = bo.next_delay()
            if delay is None:
                raise RuntimeEnvError(f"runtime_env package {uri} not found in GCS")
            _time.sleep(delay)
        tmp = final + ".staging"
        if os.path.isdir(tmp):
            import shutil

            shutil.rmtree(tmp)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        for root, _dirs, files in os.walk(tmp):
            for f in files:
                full = os.path.join(root, f)
                info_mode = os.stat(full).st_mode
                os.chmod(full, info_mode | 0o600)
        os.replace(tmp, final)
    return final


def _stage_pip(specs: List[str], dest_dir: str) -> str:
    """``pip install --target`` into a content-addressed dir.  The
    reference builds a full virtualenv (pip.py); --target + sys.path
    gives the same import semantics for pure-python deps without the
    venv spin-up cost, and works with local wheel paths offline."""
    h = hashlib.sha1(json.dumps(specs).encode()).hexdigest()[:16]
    final = os.path.join(dest_dir, f"pip-{h}")
    marker = os.path.join(final, ".ray_tpu_complete")
    if os.path.exists(marker):
        return final
    with _FileLock(final + ".lock"):
        if os.path.exists(marker):
            return final
        cmd = [
            sys.executable, "-m", "pip", "install",
            "--target", final, "--no-input", "--disable-pip-version-check",
        ] + list(specs)
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=600
        )
        if proc.returncode != 0:
            raise RuntimeEnvError(
                f"pip install of {specs} failed:\n{proc.stdout}\n{proc.stderr}"
            )
        with open(marker, "w") as f:
            f.write("ok")
    return final


def stage_and_apply(env: Optional[dict], gcs_client, session_dir: str) -> None:
    """Worker-process side: materialize the env and mutate this process
    (cwd, sys.path, os.environ) to match.  Raises RuntimeEnvError on any
    failure — the caller reports it to the raylet instead of crashing."""
    if not env:
        return
    res_dir = _resources_dir(session_dir)
    os.makedirs(res_dir, exist_ok=True)
    if env.get("pip"):
        target = _stage_pip(env["pip"], res_dir)
        sys.path.insert(0, target)
        os.environ["PYTHONPATH"] = target + os.pathsep + os.environ.get("PYTHONPATH", "")
    for uri in reversed(env.get("py_modules", ())):
        staged = _fetch_package(gcs_client, uri, res_dir, session_dir)
        sys.path.insert(0, staged)
        os.environ["PYTHONPATH"] = staged + os.pathsep + os.environ.get("PYTHONPATH", "")
    wd = env.get("working_dir")
    if wd:
        staged = _fetch_package(gcs_client, wd, res_dir, session_dir)
        os.chdir(staged)
        sys.path.insert(0, staged)
        os.environ["PYTHONPATH"] = staged + os.pathsep + os.environ.get("PYTHONPATH", "")
    for k, v in (env.get("env_vars") or {}).items():
        os.environ[k] = v
    # plugin fields stage last, in priority order (reference: plugin.py
    # priority-ordered plugin setup)
    for key, plugin in sorted(_plugins.items(), key=lambda kv: kv[1].priority):
        if key in env:
            plugin.stage(env[key], gcs_client, session_dir)
