"""graftlint command line: ``python -m ray_tpu_torch.devtools.lint`` / ``graftlint``.

Exit codes: 0 = clean (all violations suppressed or none), 1 = unsuppressed
violations (or parse errors / stale baseline entries under --strict),
2 = bad invocation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_tpu_torch.devtools.lint import baseline as baseline_mod
from ray_tpu_torch.devtools.lint import core


def _default_paths(root: str) -> List[str]:
    return [os.path.join(root, "ray_tpu_torch")]


def main(argv: Optional[List[str]] = None) -> int:
    from ray_tpu_torch.devtools.lint.checkers import CHECK_NAMES

    ap = argparse.ArgumentParser(
        prog="graftlint",
        description=(
            "AST-based concurrency & invariant analyzer for the ray_tpu_torch "
            "distributed core (see docs/static_analysis.md)"
        ),
    )
    ap.add_argument("paths", nargs="*", help="files/dirs to lint (default: ray_tpu_torch/)")
    ap.add_argument(
        "--root",
        default=None,
        help="repo root (default: nearest dir with pyproject.toml)",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"suppression baseline (default: <root>/{baseline_mod.DEFAULT_NAME})",
    )
    ap.add_argument(
        "--no-baseline", action="store_true", help="ignore the baseline entirely"
    )
    ap.add_argument(
        "--select",
        default=None,
        help="comma-separated checks to run (default: all)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    ap.add_argument(
        "--json",
        action="store_const",
        const="json",
        dest="fmt",
        help="shorthand for --format json (machine-readable report)",
    )
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help="parse fresh instead of using the content-hash AST cache",
    )
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed violations and their reasons",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="stale (unmatched) baseline entries and parse errors fail the run",
    )
    ap.add_argument(
        "--write-baseline",
        metavar="PATH",
        default=None,
        help=(
            "write a bootstrap baseline covering today's unsuppressed "
            "violations (reasons are TODO placeholders: fill them in or the "
            "baseline will not load)"
        ),
    )
    ap.add_argument("--list-checks", action="store_true")
    args = ap.parse_args(argv)

    if args.list_checks:
        for n in CHECK_NAMES:
            print(n)
        return 0

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
        unknown = set(select) - set(CHECK_NAMES) - {"bad-suppression"}
        if unknown:
            print(f"graftlint: unknown checks: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    if args.paths:
        paths = args.paths
        root = args.root or core.repo_root_for(paths[0])
    else:
        root = args.root or core.repo_root_for(os.getcwd())
        paths = _default_paths(root)
        if not os.path.isdir(paths[0]):
            print(f"graftlint: no ray_tpu_torch/ under {root}; pass paths explicitly",
                  file=sys.stderr)
            return 2

    bl = None
    if not args.no_baseline:
        try:
            if args.baseline:
                bl = baseline_mod.load(args.baseline)
            else:
                bl = baseline_mod.load_default(root)
        except (baseline_mod.BaselineError, OSError) as e:
            print(f"graftlint: bad baseline: {e}", file=sys.stderr)
            return 2

    result = core.run_lint(
        paths, root=root, baseline=bl, select=select,
        use_cache=not args.no_cache,
    )

    if args.write_baseline:
        n = baseline_mod.write(args.write_baseline, result.unsuppressed)
        print(f"graftlint: wrote {n} entries to {args.write_baseline} "
              "(fill in the TODO reasons before checking it in)")
        return 0

    if args.fmt == "json":
        run_checks = select if select is not None else CHECK_NAMES
        by_check = {c: 0 for c in run_checks}
        for v in result.unsuppressed:
            by_check[v.check] = by_check.get(v.check, 0) + 1
        print(json.dumps(
            {
                "files_checked": result.files_checked,
                "elapsed_s": round(result.elapsed_s, 3),
                "checks_run": list(run_checks),
                "unsuppressed": len(result.unsuppressed),
                "suppressed": len(result.suppressed),
                "by_check": by_check,
                "cache": {"hits": result.cache_hits, "misses": result.cache_misses},
                "violations": [v.__dict__ for v in result.violations],
                "parse_errors": [v.__dict__ for v in result.parse_errors],
                "unused_baseline": result.unused_baseline,
            },
            indent=2,
        ))
    else:
        for v in result.unsuppressed:
            print(v.format())
        if args.show_suppressed:
            for v in result.suppressed:
                print(f"[suppressed:{v.suppressed_by}] {v.format()}")
        for v in result.parse_errors:
            print(v.format(), file=sys.stderr)
        for e in result.unused_baseline:
            print(
                "graftlint: stale baseline entry (matches nothing): "
                f"{e['check']} @ {e['path']}"
                + (f" [{e.get('symbol')}]" if e.get("symbol") else ""),
                file=sys.stderr,
            )
        n_bad = len(result.unsuppressed)
        summary = (
            f"graftlint: {result.files_checked} files, "
            f"{n_bad} unsuppressed violation(s), "
            f"{len(result.suppressed)} suppressed, "
            f"{result.elapsed_s:.2f}s"
        )
        print(summary, file=sys.stderr if n_bad else sys.stdout)

    failed = bool(result.unsuppressed)
    if args.strict and (result.parse_errors or result.unused_baseline):
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
