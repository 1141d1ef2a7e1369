"""Dashboard: HTTP API + job submission (reference:
python/ray/dashboard/dashboard.py, dashboard/modules/job/).

The dashboard runs as a thread inside the head node process, serving:

- ``GET /api/...`` — cluster state (nodes, actors, tasks, jobs, objects,
  placement groups, workers, summaries) straight from the GCS tables and
  raylet stats, the same sources as :mod:`ray_tpu_torch.util.state`.
- ``GET /metrics`` — Prometheus text.
- ``POST /api/jobs/`` etc. — REST job submission with a supervisor
  process per job (reference: dashboard/modules/job/job_manager.py).
- ``GET /`` — a server-rendered HTML status page (the reference's React
  frontend is out of scope; the data endpoints are the contract).

Client side: :class:`ray_tpu_torch.dashboard.sdk.JobSubmissionClient` mirrors
the reference SDK (reference: dashboard/modules/job/sdk.py:35).
"""

from ray_tpu_torch.dashboard.http_server import start_dashboard
from ray_tpu_torch.dashboard.sdk import JobSubmissionClient

__all__ = ["start_dashboard", "JobSubmissionClient"]
