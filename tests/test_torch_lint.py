"""graftlint over the PyTorch/CUDA port: ray_tpu_torch/ lints clean with
``--strict`` against the port's own baseline (tests/torch_graftlint.toml,
a reason on every entry, no stale entry).

The port carries its own copy of graftlint (``python -m
ray_tpu_torch.devtools.lint``), whose allow-lists of canonical files name
the port's files and whose metrics-drift catalog is
``docs/torch_observability.md``.  Every check runs here, metrics-drift
included.
"""

import os
import subprocess
import sys

from ray_tpu_torch.devtools.lint.checkers import CHECK_NAMES

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "tests", "torch_graftlint.toml")
CHECKS = ("retry-gate", "lock-order", "thread-lifecycle", "blocking-in-handler",
          "generation-key", "import-cycle", "trace-orphan", "rpc-contract",
          "shared-state-race", "metrics-drift")


def test_port_lints_clean_with_strict():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "ray_tpu_torch", "--strict",
         "--baseline", BASELINE, "--select", ",".join(CHECKS)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 unsuppressed violation(s)" in proc.stdout + proc.stderr


def test_port_baseline_gives_every_entry_a_reason():
    from ray_tpu_torch.devtools.lint import baseline as baseline_mod

    bl = baseline_mod.load(BASELINE)
    assert bl.entries
    for e in bl.entries:
        assert e.path.startswith("ray_tpu_torch/"), e
        assert e.reason.strip() and not e.reason.lower().startswith("todo"), e
    # the port's allow-lists name its own canonical helpers: no entry
    # stands in for them any more
    assert not [e for e in bl.entries if e.check == "generation-key"]


def test_the_selection_leaves_out_only_metrics_drift():
    """The name is kept from when the selection left metrics-drift out;
    it now leaves out no check at all."""
    assert set(CHECK_NAMES) - set(CHECKS) == set()
    assert set(CHECKS) <= set(CHECK_NAMES)
