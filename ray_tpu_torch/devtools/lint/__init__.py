"""graftlint — AST-based concurrency & invariant analyzer for ray_tpu_torch.

The runtime rests on distributed-systems invariants that would otherwise
live only in people's heads: every retry loop must ride a
``_private/retry.py`` policy, no blocking sleeps on RPC dispatch or
pubsub threads, spawned threads need a daemon flag or a join path, lock
acquisition order must stay acyclic, the metrics catalog must match the
instruments that actually exist, and rendezvous/checkpoint keys must go
through the canonical generation-scoped helpers.  graftlint walks the
whole ``ray_tpu_torch/`` tree (stdlib ``ast`` only, no third-party deps) and
enforces them on every PR, with a checked-in suppression baseline
(``.graftlint.toml``) so accepted exceptions are explicit and diffable.

Run it::

    python -m ray_tpu_torch.devtools.lint [paths ...]

Checker catalog and suppression format: docs/static_analysis.md.

Port of the JAX package's ``devtools/lint``: the imports are renamed, and
the default path and every checker's allow-list of canonical files name
``ray_tpu_torch/``; the checkers' logic is the reference's line for line.
"""

from ray_tpu_torch.devtools.lint.core import LintResult, Violation, run_lint

__all__ = ["LintResult", "Violation", "run_lint"]
