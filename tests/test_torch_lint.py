"""graftlint over the PyTorch/CUDA port: ray_tpu_torch/ lints clean with
``--strict`` against the port's own baseline (tests/torch_graftlint.toml,
a reason on every entry, no stale entry).

graftlint is the JAX package's analyzer (``python -m
ray_tpu.devtools.lint``); its own gate lints only ``ray_tpu/`` and
``tests/``.  Every check runs here except metrics-drift: its catalog
direction holds docs/observability.md's rows against the instruments the
linted tree creates, and the rows name the JAX package's instruments
(serve, dag, channel, RLlib, pipeline), most of which the port has not
ported yet.
"""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "tests", "torch_graftlint.toml")
CHECKS = ("retry-gate", "lock-order", "thread-lifecycle", "blocking-in-handler",
          "generation-key", "import-cycle", "trace-orphan", "rpc-contract",
          "shared-state-race")


def test_port_lints_clean_with_strict():
    pytest.importorskip("ray_tpu.devtools.lint")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu.devtools.lint", "ray_tpu_torch", "--strict",
         "--baseline", BASELINE, "--select", ",".join(CHECKS)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 unsuppressed violation(s)" in proc.stdout + proc.stderr


def test_port_baseline_gives_every_entry_a_reason():
    from ray_tpu.devtools.lint import baseline as baseline_mod

    bl = baseline_mod.load(BASELINE)
    assert bl.entries
    for e in bl.entries:
        assert e.path.startswith("ray_tpu_torch/"), e
        assert e.reason.strip() and not e.reason.lower().startswith("todo"), e


def test_the_selection_leaves_out_only_metrics_drift():
    from ray_tpu.devtools.lint.checkers import CHECK_NAMES

    assert set(CHECK_NAMES) - set(CHECKS) == {"metrics-drift"}
