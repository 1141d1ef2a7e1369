"""Content-addressed AST cache for the lint gate.

Parsing ~270 files costs more wall time than any single checker, and the
tree for a given file is a pure function of its bytes — so the gate
memoizes ``ast.parse`` keyed on the sha256 of the source.  One pickle
file per source file, named by content hash, under
``<root>/.graftlint_cache/`` (gitignored): an edit changes the hash and
simply misses, so there is no invalidation protocol, and stale entries
from old revisions are pruned opportunistically once the directory
outgrows the tree being linted.

The cache is best-effort everywhere: any OSError / corrupt pickle falls
back to a fresh parse.  Entries are versioned by the running
interpreter's (major, minor) because pickled AST nodes do not travel
across Python versions.  Disable with GRAFTLINT_NO_CACHE=1 (or the CLI's
``--no-cache``).
"""

from __future__ import annotations

import ast
import hashlib
import os
import pickle
import sys
from typing import Optional

__all__ = ["AstCache"]

_VERSION = f"py{sys.version_info[0]}{sys.version_info[1]}v1"


class AstCache:
    def __init__(self, root: str, enabled: bool = True):
        self.dir = os.path.join(root, ".graftlint_cache")
        self.enabled = enabled and os.environ.get("GRAFTLINT_NO_CACHE") != "1"
        self.hits = 0
        self.misses = 0
        self._ready = False

    def _ensure_dir(self) -> bool:
        if not self._ready:
            try:
                os.makedirs(self.dir, exist_ok=True)
            except OSError:
                self.enabled = False
                return False
            self._ready = True
        return True

    @staticmethod
    def _key(src: str) -> str:
        return hashlib.sha256(src.encode("utf-8", "surrogatepass")).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.{_VERSION}.astpkl")

    def parse(self, src: str, filename: str) -> ast.AST:
        """``ast.parse`` with cache; SyntaxError propagates (and is never
        cached — a bad file re-parses each run, which is both rare and
        the signal the gate must re-surface)."""
        if not self.enabled:
            return ast.parse(src, filename=filename)
        key = self._key(src)
        path = self._path(key)
        try:
            with open(path, "rb") as fh:
                tree = pickle.load(fh)
            self.hits += 1
            return tree
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError, ValueError):
            pass
        tree = ast.parse(src, filename=filename)
        self.misses += 1
        self._store(path, key, tree)
        return tree

    def _store(self, path: str, key: str, tree: ast.AST) -> None:
        if not self._ensure_dir():
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(tree, fh, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)  # atomic: concurrent gates never read torn pickles
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def prune(self, keep_under: int = 2048) -> None:
        """Drop oldest entries once the dir holds more than ``keep_under``
        files (several tree-revisions of slack before any eviction)."""
        if not self.enabled or not self._ready:
            return
        try:
            names = os.listdir(self.dir)
            if len(names) <= keep_under:
                return
            paths = [os.path.join(self.dir, n) for n in names]
            paths.sort(key=lambda p: os.path.getmtime(p))
            for p in paths[: len(paths) - keep_under]:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        except OSError:
            pass
