"""metrics-drift: the observability catalog must match the instruments.

``docs/torch_observability.md`` is the operator's map of every built-in metric;
it goes stale the moment someone adds an instrument to
``_private/telemetry.py`` (or anywhere via ``util.metrics``) without a
catalog row — or deletes one and leaves the row behind.  This checker
diffs the two in both directions:

- an instrument created in code (``Counter/Gauge/Histogram("name", ...)``
  with a literal name) but absent from the catalog table -> violation at
  the creation site;
- a catalog row naming an instrument no code creates -> violation at the
  docs line (wildcard rows like ``test_*`` are ignored).

It also flags **unbounded-cardinality label values** at record sites:
passing ``tags={...}`` where a value is an f-string or ``str(<id-like>)``
mints a new time series per distinct value — ids, addresses, and paths
must never become label values (the GCS metrics table and every scrape
grow without bound).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Tuple

from ray_tpu_torch.devtools.lint.core import Module, Project, Violation, call_name

name = "metrics-drift"

DOCS_RELPATH = "docs/torch_observability.md"

_INSTRUMENT_CLASSES = ("Counter", "Gauge", "Histogram")
_META_KWARGS = {"description", "tag_keys", "boundaries"}
_ID_LIKE = re.compile(
    r"(^|_)(id|uuid|addr|address|host|port|path|key|token|trace|span)s?$"
)

_EXEMPT_DIRS = ("ray_tpu_torch/devtools/",)
_EXEMPT_FILES = ("ray_tpu_torch/util/metrics.py",)


def _instrument_calls(mod: Module) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node).split(".")[-1]
        if cn not in _INSTRUMENT_CLASSES:
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant) or \
                not isinstance(node.args[0].value, str):
            continue
        # Distinguish a util.metrics instrument from e.g.
        # collections.Counter("x"): require metric-shaped metadata.
        has_meta = any(kw.arg in _META_KWARGS for kw in node.keywords) or (
            len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)
        )
        if not has_meta:
            continue
        out.append((node.args[0].value, node.lineno))
    return out


def _catalog_names(docs_path: str) -> Tuple[Dict[str, int], List[str]]:
    """Backticked instrument names from the '## Metric catalog' table,
    plus wildcard family rows (``test_*``) as fnmatch patterns — an
    instrument matching a documented family needs no literal row."""
    names: Dict[str, int] = {}
    patterns: List[str] = []
    try:
        with open(docs_path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return names, patterns
    in_catalog = False
    for i, line in enumerate(lines, start=1):
        if line.startswith("## "):
            in_catalog = line.strip() == "## Metric catalog"
            continue
        if not in_catalog or not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if not cells or cells[0] in ("name", "") or set(cells[0]) <= {"-", " "}:
            continue
        m = re.match(r"`([A-Za-z0-9_*]+)`", cells[0])
        if m:
            if "*" in m.group(1):
                patterns.append(m.group(1))
            else:
                names[m.group(1)] = i
    return names, patterns


def _suspicious_tag_value(v: ast.AST) -> bool:
    if isinstance(v, ast.JoinedStr):
        return any(isinstance(p, ast.FormattedValue) for p in v.values)
    if isinstance(v, ast.Call) and call_name(v) == "str" and v.args:
        inner = v.args[0]
        label = ""
        if isinstance(inner, ast.Name):
            label = inner.id
        elif isinstance(inner, ast.Attribute):
            label = inner.attr
        return bool(_ID_LIKE.search(label))
    return False


def check_project(project: Project) -> Iterable[Violation]:
    out: List[Violation] = []
    created: Dict[str, Tuple[str, int]] = {}
    for mod in project.modules:
        if mod.relpath in _EXEMPT_FILES or any(
            mod.relpath.startswith(d) for d in _EXEMPT_DIRS
        ):
            continue
        for metric_name, line in _instrument_calls(mod):
            created.setdefault(metric_name, (mod.relpath, line))
        # Unbounded-cardinality tag values at record sites.
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = call_name(node).split(".")[-1]
            if leaf not in ("inc", "observe", "set", "bound"):
                continue
            for kw in node.keywords:
                if kw.arg != "tags" or not isinstance(kw.value, ast.Dict):
                    continue
                for k, v in zip(kw.value.keys, kw.value.values):
                    if v is not None and _suspicious_tag_value(v):
                        key_label = (
                            k.value if isinstance(k, ast.Constant) else "<expr>"
                        )
                        out.append(
                            Violation(
                                check=name,
                                path=mod.relpath,
                                line=node.lineno,
                                symbol=mod.enclosing_qualname(node),
                                tag=f"cardinality:{key_label}",
                                message=(
                                    f"label {key_label!r} gets an interpolated/"
                                    "id-like value — unbounded label "
                                    "cardinality mints a new series per value; "
                                    "use a bounded enum or drop the label"
                                ),
                            )
                        )
    docs_abs = os.path.join(project.root, DOCS_RELPATH)
    catalog, family_patterns = _catalog_names(docs_abs)
    if not catalog and not os.path.exists(docs_abs):
        return out  # fixture trees without docs only get cardinality checks

    from fnmatch import fnmatchcase

    for metric_name, (rel, line) in sorted(created.items()):
        if any(fnmatchcase(metric_name, p) for p in family_patterns):
            continue  # covered by a documented wildcard family row
        if metric_name not in catalog:
            out.append(
                Violation(
                    check=name,
                    path=rel,
                    line=line,
                    symbol=metric_name,
                    tag=f"undocumented:{metric_name}",
                    message=(
                        f"instrument {metric_name!r} is not in the "
                        f"{DOCS_RELPATH} metric catalog — add a row "
                        "(name, type, tags, meaning)"
                    ),
                )
            )
    for metric_name, line in sorted(catalog.items()):
        if metric_name not in created:
            out.append(
                Violation(
                    check=name,
                    path=DOCS_RELPATH,
                    line=line,
                    symbol=metric_name,
                    tag=f"orphaned:{metric_name}",
                    message=(
                        f"catalog row {metric_name!r} names an instrument no "
                        "code creates — delete the row or restore the metric"
                    ),
                )
            )
    return out
