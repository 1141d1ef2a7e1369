"""generation-key: rendezvous/checkpoint keys go through canonical helpers.

The elastic plane hangs correctness off two key formats:

- collective rendezvous KV keys ``<group>/gen<G>/<rank>`` plus the
  ``<group>/gen`` marker — built ONLY by
  ``util/collective/cpu_group.py`` (``_key``/``_gen_key``) and reaped by
  ``util/collective/collective.py``;
- generation-scoped checkpoint dirs ``checkpoint_gGGG_NNNNNN_rankR`` —
  built ONLY by ``train/_internal/session.py`` and parsed by
  ``train/base_trainer.py``.

A hand-rolled key string anywhere else silently bypasses generation
discipline: a stale-format writer can collide with (or regress) a bumped
generation, which is exactly the resume-dir overwrite desync it once shipped.
The checker flags any string literal or f-string fragment outside the
canonical modules that builds either shape (``.../gen<digit|{|<|/|end>``
or ``checkpoint_g...``).  Docstrings are exempt (they may *describe* the
format).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from ray_tpu_torch.devtools.lint.core import Module, Violation, is_docstring

name = "generation-key"

_CANONICAL_FILES = (
    "ray_tpu_torch/util/collective/cpu_group.py",
    "ray_tpu_torch/util/collective/collective.py",
    "ray_tpu_torch/train/_internal/session.py",
    "ray_tpu_torch/train/base_trainer.py",
)

# "/gen" followed by a digit, an interpolation hole, a separator, or
# end-of-string (the marker key) — but not a word like "/general".
_GEN_KEY = re.compile(r"/gen(?=\d|\{|<|/|$)")
_CKPT_KEY = re.compile(r"checkpoint_g(?=\d|\{)")


def _fragments(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.JoinedStr):
        # Render interpolation holes as "{" so the regexes can anchor on
        # them: f"{g}/gen{n}/{r}" -> "{/gen{/{".
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("{")
        return ["".join(parts)]
    return []


def check(mod: Module) -> Iterable[Violation]:
    if mod.relpath in _CANONICAL_FILES:
        return []
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, str) or is_docstring(mod, node):
                continue
            # Skip fragments nested in a JoinedStr (handled there).
            parent = mod.parents.get(node)
            if isinstance(parent, ast.JoinedStr):
                continue
            frags = [node.value]
        elif isinstance(node, ast.JoinedStr):
            frags = _fragments(node)
        else:
            continue
        for frag in frags:
            which = None
            if _GEN_KEY.search(frag):
                which = "rendezvous key"
            elif _CKPT_KEY.search(frag):
                which = "checkpoint dir"
            if which:
                out.append(
                    Violation(
                        check=name,
                        path=mod.relpath,
                        line=node.lineno,
                        symbol=mod.enclosing_qualname(node),
                        tag=f"{which}:{frag[:40]}",
                        message=(
                            f"hand-rolled generation-scoped {which} string "
                            f"{frag[:60]!r} — use the canonical helpers "
                            "(cpu_group._key/_gen_key for rendezvous, "
                            "session checkpoint naming for dirs); a bypassed "
                            "format breaks generation discipline"
                        ),
                    )
                )
                break
    return out
