"""Node bootstrap: command runners + updater (reference:
python/ray/autoscaler/_private/command_runner.py:1 SSHCommandRunner +
updater.py NodeUpdater, reduced to the essential contract: run an
ordered command list on a node, mark the node up-to-date or failed).

The process launcher is INJECTED (``process_runner`` — default
subprocess.run), so tests assert the exact command streams without a
real SSH target, and a future kubernetes/GCE-oslogin runner only swaps
the argv builder.
"""

from __future__ import annotations

import logging
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class CommandRunnerError(RuntimeError):
    def __init__(self, cmd: str, returncode: int, output: str):
        super().__init__(f"command failed (rc={returncode}): {cmd}\n{output[-2000:]}")
        self.cmd = cmd
        self.returncode = returncode


class CommandRunner:
    """Run shell commands on one node."""

    def run(self, cmd: str, *, timeout: float = 600.0) -> str:
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    """Run on this host (on-prem/dry-run node types whose 'nodes' are
    local processes)."""

    def __init__(self, process_runner: Optional[Callable] = None):
        self._run = process_runner or subprocess.run

    def run(self, cmd: str, *, timeout: float = 600.0) -> str:
        proc = self._run(
            ["bash", "-c", cmd], capture_output=True, text=True, timeout=timeout
        )
        if proc.returncode != 0:
            raise CommandRunnerError(cmd, proc.returncode, proc.stderr or proc.stdout or "")
        return proc.stdout or ""


class SSHCommandRunner(CommandRunner):
    """Run over ssh (reference: command_runner.py SSHCommandRunner —
    BatchMode, ConnectTimeout, IdentityFile, known-hosts off for
    ephemeral cloud IPs)."""

    def __init__(
        self,
        ip: str,
        *,
        user: str = "ray",
        ssh_key: Optional[str] = None,
        port: int = 22,
        process_runner: Optional[Callable] = None,
    ):
        self.ip = ip
        self.user = user
        self.ssh_key = ssh_key
        self.port = port
        self._run = process_runner or subprocess.run

    def _argv(self, cmd: str) -> List[str]:
        import shlex

        argv = [
            "ssh",
            "-o", "BatchMode=yes",
            "-o", "ConnectTimeout=10",
            "-o", "StrictHostKeyChecking=no",
            "-o", "UserKnownHostsFile=/dev/null",
            "-p", str(self.port),
        ]
        if self.ssh_key:
            argv += ["-i", self.ssh_key]
        # shlex.quote, not hand-rolled quotes: setup commands routinely
        # contain single quotes (echo 'export ...' >> ~/.bashrc)
        argv += [f"{self.user}@{self.ip}", "bash", "-c", shlex.quote(cmd)]
        return argv

    def run(self, cmd: str, *, timeout: float = 600.0) -> str:
        proc = self._run(
            self._argv(cmd), capture_output=True, text=True, timeout=timeout
        )
        if proc.returncode != 0:
            raise CommandRunnerError(cmd, proc.returncode, proc.stderr or proc.stdout or "")
        return proc.stdout or ""


class NodeUpdater:
    """Drive one node from allocated to ray-running (reference:
    updater.py NodeUpdater.run): wait for the node, then run
    initialization_commands, setup_commands, start_ray_commands in
    order.  Raises CommandRunnerError on the first failure; the caller
    (provider/autoscaler) marks the node update-failed."""

    def __init__(
        self,
        runner: CommandRunner,
        *,
        initialization_commands: Optional[List[str]] = None,
        setup_commands: Optional[List[str]] = None,
        start_ray_commands: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        self.runner = runner
        self.initialization_commands = initialization_commands or []
        self.setup_commands = setup_commands or []
        self.start_ray_commands = start_ray_commands or []
        self.env = env or {}

    def _with_env(self, cmd: str) -> str:
        if not self.env:
            return cmd
        import shlex

        exports = " ".join(f"{k}={shlex.quote(str(v))}" for k, v in self.env.items())
        return f"export {exports}; {cmd}"

    def update(self, *, deadline_s: float = 900.0) -> None:
        start = time.monotonic()
        for phase, cmds in (
            ("initialization", self.initialization_commands),
            ("setup", self.setup_commands),
            ("start_ray", self.start_ray_commands),
        ):
            for cmd in cmds:
                remaining = deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    raise CommandRunnerError(cmd, -1, f"{phase}: update deadline exceeded")
                logger.info("node update [%s]: %s", phase, cmd)
                self.runner.run(self._with_env(cmd), timeout=remaining)
