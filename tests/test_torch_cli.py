"""The port's CLI (``python -m ray_tpu_torch.scripts.cli``, the
``ray-tpu-torch`` console script): a blocking head started with
``--num-gpus`` and read back by ``status``, and ``stop``, which names
only the port's own processes.  No test runs ``stop`` for real: it ends
every port process of the user, other test workers' clusters included.
"""

import os
import re
import subprocess
import sys
import threading
import time

from ray_tpu_torch._private import retry

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAY_TPU_TORCH_")}
    # a temp dir of the test's own: its session root and cluster-address
    # file are apart from every other cluster's
    env.update(PYTHONPATH=REPO_ROOT, TMPDIR=str(tmp_path), PYTHONUNBUFFERED="1",
               RAY_TPU_TORCH_arena_prefault_bytes="0",
               RAY_TPU_TORCH_memory_monitor_enabled="0")
    return env


def _wait_line(lines: list, prefix: str, proc, deadline_s: float) -> str:
    """The first line the CLI printed that starts with ``prefix`` (a
    reader thread appends the CLI's lines to ``lines``)."""
    bo = retry.POLL.start(deadline_s=deadline_s)
    while True:
        for line in list(lines):
            if line.startswith(prefix):
                return line[len(prefix):].strip()
        delay = bo.next_delay()
        if delay is None or proc.poll() is not None:
            raise AssertionError(f"the CLI never printed {prefix!r} (exit code "
                                 f"{proc.poll()}): {lines}")
        time.sleep(delay)


def _processes_of(session_dir: str) -> list:
    """pids of live processes whose command line names ``session_dir``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if session_dir in cmd:
            out.append(int(pid))
    return out


def test_cli_start_head_with_num_gpus_block_and_status(tmp_path):
    env = _cli_env(tmp_path)
    cli = [sys.executable, "-m", "ray_tpu_torch.scripts.cli"]
    proc = subprocess.Popen(cli + ["start", "--head", "--num-cpus", "2", "--num-gpus", "0",
                                   "--block"],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    session_dir = None
    try:
        gcs = _wait_line(lines, "started head: gcs=", proc, 60)
        session_dir = _wait_line(lines, "session dir: ", proc, 60)
        assert gcs.startswith(f"unix:{session_dir}/")
        status = subprocess.run(cli + ["status"], cwd=str(tmp_path), env=env,
                                capture_output=True, text=True, timeout=60)
        assert status.returncode == 0, status.stdout + status.stderr
        assert "nodes: 1 alive / 1 total" in status.stdout, status.stdout
        totals = dict(re.findall(r"^  (\w+): [\d.e+]+/([\d.e+]+) available$",
                                 status.stdout, re.MULTILINE))
        assert float(totals["CPU"]) == 2.0
        assert float(totals.get("GPU", 0)) == 0.0  # --num-gpus 0 on any machine
        # ending the blocking CLI ends its head: the head watches its owner
        proc.terminate()
        proc.wait(timeout=30)
        bo = retry.POLL.start(deadline_s=30)
        while _processes_of(session_dir):
            delay = bo.next_delay()
            if delay is None:
                break
            time.sleep(delay)
        assert _processes_of(session_dir) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in _processes_of(session_dir) if session_dir else []:
            os.kill(pid, 9)
        reader.join(timeout=10)
        proc.stdout.close()


def test_cli_stop_names_only_the_ports_processes(tmp_path, monkeypatch):
    """``stop`` kills by a pattern that matches the port's head, raylets
    and workers and never the JAX package's, and removes the port's
    cluster-address file."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch.scripts import cli

    calls = []

    class _Done:
        returncode = 0

    monkeypatch.setattr(cli.subprocess, "run", lambda argv, **kw: calls.append(argv) or _Done())
    address_file = tmp_path / "ray_current_cluster"
    address_file.write_text("unix:/nowhere/gcs.sock")
    monkeypatch.setattr(node_mod, "CLUSTER_ADDRESS_FILE", str(address_file))
    assert cli.main(["stop"]) == 0
    ((pkill, flag, pattern),) = calls
    assert (pkill, flag) == ("pkill", "-f")
    assert not address_file.exists()
    for entry in ("head_main", "raylet_main", "default_worker"):
        assert re.search(pattern, f"python -m ray_tpu_torch._private.{entry} --session-dir x")
        assert not re.search(pattern, f"python -m ray_tpu._private.{entry} --session-dir x")
