"""Job submission SDK (reference: dashboard/modules/job/sdk.py:35
JobSubmissionClient).  stdlib-urllib client for the dashboard's REST
API — no external HTTP dependency."""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional
from urllib import error, request


class JobSubmissionClient:
    def __init__(self, address: str):
        """address: "http://127.0.0.1:8265" (the dashboard URL)."""
        self._base = address.rstrip("/")

    # -- raw HTTP -------------------------------------------------------
    def _call(self, method: str, path: str, body: Optional[dict] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = request.Request(
            self._base + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"null")
        except error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", "")
            except Exception:
                detail = str(e)
            raise RuntimeError(f"{method} {path} failed ({e.code}): {detail}") from None

    # -- API ------------------------------------------------------------
    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        tenant: Optional[str] = None,
        priority: int = 0,
        quota: Optional[dict] = None,
    ) -> str:
        """``tenant``/``priority`` tag the job for the multi-tenant
        scheduler; ``quota`` registers the tenant's resource quota (e.g.
        ``{"CPU": 8}``) at submission time."""
        reply = self._call(
            "POST",
            "/api/jobs/",
            {
                "entrypoint": entrypoint,
                "submission_id": submission_id,
                "runtime_env": runtime_env,
                "metadata": metadata,
                "tenant": tenant,
                "priority": priority,
                "quota": quota,
            },
        )
        return reply["submission_id"]

    def list_tenants(self) -> List[Dict[str, Any]]:
        """Registered tenants with quota, live usage and dominant share."""
        return self._call("GET", "/api/tenants")

    def set_tenant_quota(
        self,
        tenant: str,
        quota: Optional[dict] = None,
        weight: Optional[float] = None,
        priority: Optional[int] = None,
    ) -> Dict[str, Any]:
        return self._call(
            "POST",
            "/api/tenants",
            {"tenant": tenant, "quota": quota, "weight": weight,
             "priority": priority},
        )

    def get_job_status(self, submission_id: str) -> str:
        return self._call("GET", f"/api/jobs/{submission_id}")["status"]

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/api/jobs/{submission_id}")

    def get_job_logs(self, submission_id: str) -> str:
        return self._call("GET", f"/api/jobs/{submission_id}/logs")["logs"]

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._call("GET", "/api/jobs/")

    def stop_job(self, submission_id: str) -> bool:
        return self._call("POST", f"/api/jobs/{submission_id}/stop")["stopped"]

    def delete_job(self, submission_id: str) -> bool:
        return self._call("DELETE", f"/api/jobs/{submission_id}")["deleted"]

    def wait_until_finished(
        self, submission_id: str, timeout: float = 300, poll_s: float = 0.5
    ) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {submission_id} still {status} after {timeout}s")
