"""Worker process entrypoint (reference:
python/ray/_private/workers/default_worker.py).  Connects back to the
raylet that spawned it (addresses via env) and runs the task loop."""

from __future__ import annotations

import logging
import sys


def main():
    logging.basicConfig(level=logging.INFO, format="[worker %(asctime)s] %(message)s")
    import os

    # Debugging aid: RAY_TPU_TORCH_WORKER_STACK_DUMP_S=N dumps every thread's
    # stack to the worker log every N seconds (hung-worker triage).
    dump_s = os.environ.get("RAY_TPU_TORCH_WORKER_STACK_DUMP_S")
    if dump_s:
        import faulthandler

        faulthandler.dump_traceback_later(float(dump_s), repeat=True, exit=False)

    from ray_tpu_torch._private.worker import get_global_worker

    worker = get_global_worker()
    worker.connect_worker()
    try:
        worker.main_loop()
    except KeyboardInterrupt:
        pass
    sys.exit(0)


if __name__ == "__main__":
    main()
