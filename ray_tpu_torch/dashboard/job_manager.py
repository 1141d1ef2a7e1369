"""Job submission manager (reference: dashboard/modules/job/job_manager.py
JobManager + job_supervisor.py JobSupervisor).

Compression of the same contract: each submitted job runs as a
supervisor *subprocess* executing the entrypoint shell command with
RAY_TPU_TORCH_ADDRESS pointing at this cluster; stdout+stderr stream to a
per-job log file under the session dir; status and metadata live in the
GCS KV so they survive dashboard restarts and are visible cluster-wide.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

JOB_KV_NS = b"dashboard_jobs"

# Terminal states (reference: job/common.py JobStatus)
TERMINAL = {"SUCCEEDED", "FAILED", "STOPPED"}


class JobManager:
    def __init__(self, gcs_client, gcs_address: str, session_dir: str):
        self._gcs = gcs_client
        self._gcs_address = gcs_address
        self._session_dir = session_dir
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    # -- KV-backed job records -----------------------------------------
    def _put(self, info: Dict[str, Any]) -> None:
        self._gcs.call(
            "kv_put",
            (JOB_KV_NS, info["submission_id"].encode(), json.dumps(info).encode(), True),
        )

    def _get(self, submission_id: str) -> Optional[Dict[str, Any]]:
        blob = self._gcs.call("kv_get", (JOB_KV_NS, submission_id.encode()))
        return json.loads(blob) if blob else None

    def list_jobs(self) -> List[Dict[str, Any]]:
        keys = self._gcs.call("kv_keys", (JOB_KV_NS, b"")) or []
        # Batched fetch instead of a kv_get round-trip per job.  The
        # stop:<id> tombstones share the namespace but are not job
        # records (their b"1" blob is not a dict) — skip them.
        keys = [k for k in keys if not k.startswith(b"stop:")]
        table = self._gcs.call("kv_multi_get", (JOB_KV_NS, keys)) or {}
        out = [json.loads(blob) for blob in table.values() if blob]
        return sorted(out, key=lambda j: j.get("start_time", 0))

    def _log_path(self, submission_id: str) -> str:
        return os.path.join(self._session_dir, "logs", f"job-{submission_id}.log")

    # -- lifecycle ------------------------------------------------------
    def submit_job(
        self,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        entrypoint_num_cpus: float = 0,
        tenant: Optional[str] = None,
        priority: int = 0,
        quota: Optional[dict] = None,
    ) -> str:
        """Submit an entrypoint.  ``tenant``/``priority`` ride into the
        driver via env (ray_tpu_torch.init picks them up), so the job's
        actors/leases are charged to that tenant and scheduled in its
        fair share; ``quota`` (resource dict) registers/updates the
        tenant's quota in the GCS at submission time."""
        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        if self._get(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        if quota is not None and tenant:
            self._gcs.call(
                "tenant_set_quota", {"tenant": tenant, "quota": quota}
            )
        info = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": "PENDING",
            "message": "queued",
            "runtime_env": runtime_env or {},
            "metadata": metadata or {},
            "tenant": tenant or "default",
            "priority": int(priority or 0),
            "start_time": time.time(),
            "end_time": None,
        }
        self._put(info)
        threading.Thread(
            target=self._run_supervisor, args=(info,), daemon=True,
            name=f"job-supervisor-{submission_id[:12]}",
        ).start()
        return submission_id

    def _run_supervisor(self, info: Dict[str, Any]) -> None:
        submission_id = info["submission_id"]
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self._gcs_address
        env["RAY_TPU_TORCH_JOB_SUBMISSION_ID"] = submission_id
        env["RAY_TPU_TORCH_TENANT"] = info.get("tenant") or "default"
        env["RAY_TPU_TORCH_PRIORITY"] = str(info.get("priority") or 0)
        if info.get("runtime_env"):
            # Port: the driver's init() takes this as its runtime_env; the
            # reference's writes it and never reads it back.
            env["RAY_TPU_TORCH_JOB_RUNTIME_ENV"] = json.dumps(info["runtime_env"])
        log_path = self._log_path(submission_id)
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        try:
            with open(log_path, "ab") as log:
                proc = subprocess.Popen(
                    ["/bin/sh", "-c", info["entrypoint"]],
                    env=env,
                    stdout=log,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
        except OSError as e:
            info.update(status="FAILED", message=f"failed to start: {e}", end_time=time.time())
            self._put(info)
            return
        with self._lock:
            self._procs[submission_id] = proc
        # A stop may have landed between submit and the Popen above (its
        # _procs lookup found nothing to kill): the tombstone decides.
        if self._stop_requested(submission_id):
            try:
                proc.kill()
            except OSError:
                pass
            proc.wait()
            with self._lock:
                self._procs.pop(submission_id, None)
            self._finalize_stopped(submission_id, info)
            return
        info.update(status="RUNNING", message=f"pid {proc.pid}")
        self._put(info)
        rc = proc.wait()
        with self._lock:
            self._procs.pop(submission_id, None)
        latest = self._get(submission_id) or info
        if self._stop_requested(submission_id):
            self._finalize_stopped(submission_id, latest)
            return
        if rc == 0:
            latest.update(status="SUCCEEDED", message="exited with code 0")
        else:
            latest.update(status="FAILED", message=f"exited with code {rc}")
        latest["end_time"] = time.time()
        self._put(latest)

    def _finalize_stopped(self, submission_id: str, info: Dict[str, Any]) -> None:
        if info.get("status") != "STOPPED":
            info.update(status="STOPPED", message="stopped by user")
            info.setdefault("end_time", time.time())
            self._put(info)

    def get_job_status(self, submission_id: str) -> Optional[Dict[str, Any]]:
        return self._get(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        try:
            with open(self._log_path(submission_id)) as f:
                return f.read()
        except OSError:
            return ""

    def _stop_requested(self, submission_id: str) -> bool:
        return bool(
            self._gcs.call("kv_exists", (JOB_KV_NS, f"stop:{submission_id}".encode()))
        )

    def stop_job(self, submission_id: str) -> bool:
        info = self._get(submission_id)
        if info is None:
            return False
        # A monotone tombstone decides every stop/start race: the
        # supervisor consults it before marking RUNNING and when
        # finalizing, so a stop can never be overwritten by a concurrent
        # status transition.
        self._gcs.call("kv_put", (JOB_KV_NS, f"stop:{submission_id}".encode(), b"1", True))
        if info["status"] not in TERMINAL:
            info.update(status="STOPPED", message="stopped by user", end_time=time.time())
            self._put(info)
        with self._lock:
            proc = self._procs.get(submission_id)
        if proc is not None and proc.poll() is None:
            # SIGTERM the whole process group; escalate after a grace.
            import signal

            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except OSError:
                pass

            def _escalate():
                time.sleep(3)
                if proc.poll() is None:
                    try:
                        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                    except OSError:
                        pass

            threading.Thread(target=_escalate, daemon=True).start()
        return True

    def delete_job(self, submission_id: str) -> bool:
        info = self._get(submission_id)
        if info is None:
            return False
        if info["status"] not in TERMINAL:
            raise ValueError(f"job {submission_id} is {info['status']}; stop it first")
        self._gcs.call("kv_del", (JOB_KV_NS, submission_id.encode()))
        self._gcs.call("kv_del", (JOB_KV_NS, f"stop:{submission_id}".encode()))
        try:
            os.remove(self._log_path(submission_id))
        except OSError:
            pass
        return True
