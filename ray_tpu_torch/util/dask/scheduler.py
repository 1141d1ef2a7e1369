"""ray_dask_get: execute a dask task graph as remote tasks (reference:
python/ray/util/dask/scheduler.py:1 ray_dask_get + _rayify_task).

Graph protocol (dask spec, implemented directly so the dask package is
optional):

  * a graph is ``{key: computation}``
  * a computation is a TASK ``(callable, arg0, arg1, ...)``, a KEY of
    another graph entry, a literal, or a (possibly nested) list of
    computations
  * ``get(graph, keys)`` returns the materialized values for ``keys``

Each task becomes one remote task whose arguments are the upstream
OBJECT REFS — the runtime's scheduler resolves them, so independent
subtrees run in parallel and intermediates never round-trip through the
driver (same dataflow shape as the reference's scheduler)."""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch


def _is_task(c: Any) -> bool:
    return isinstance(c, tuple) and len(c) > 0 and callable(c[0])


def _toposort(dsk: Dict) -> List[Hashable]:
    seen: set = set()
    order: List[Hashable] = []

    def deps_of(c: Any, out: set):
        if _is_task(c):
            for a in c[1:]:
                deps_of(a, out)
        elif isinstance(c, list):
            for a in c:
                deps_of(a, out)
        elif isinstance(c, Hashable) and c in dsk:
            out.add(c)

    def visit(key, stack):
        if key in seen:
            return
        if key in stack:
            raise ValueError(f"cycle in dask graph at {key!r}")
        stack.add(key)
        d: set = set()
        deps_of(dsk[key], d)
        for dep in d:
            visit(dep, stack)
        stack.discard(key)
        seen.add(key)
        order.append(key)

    for key in dsk:
        visit(key, set())
    return order


def _execute_task(task, refs):
    """Runs INSIDE a remote task: refs arrive as materialized values;
    rebuild the computation with them substituted."""

    def build(c):
        if _is_task(c):
            fn, *args = c
            return fn(*[build(a) for a in args])
        if isinstance(c, list):
            return [build(a) for a in c]
        if isinstance(c, _Ref):
            return refs[c.index]
        return c

    return build(task)


class _Ref:
    """Placeholder marking where an upstream result plugs in."""

    def __init__(self, index: int):
        self.index = index


@ray_tpu_torch.remote
def _dask_task(task, *refs):
    return _execute_task(task, list(refs))


def ray_dask_get(dsk: Dict, keys, **kwargs):
    """dask ``get`` entry point (pass to dask.config.set(scheduler=...))."""
    produced: Dict[Hashable, Any] = {}

    for key in _toposort(dsk):
        comp = dsk[key]
        if _is_task(comp) or isinstance(comp, list):
            # swap nested key references for _Ref placeholders + ref args
            ref_args: List[Any] = []

            def swap(c):
                if _is_task(c):
                    return (c[0],) + tuple(swap(a) for a in c[1:])
                if isinstance(c, list):
                    return [swap(a) for a in c]
                if isinstance(c, Hashable) and c in produced:
                    ref_args.append(produced[c])
                    return _Ref(len(ref_args) - 1)
                return c

            produced[key] = _dask_task.remote(swap(comp), *ref_args)
        elif isinstance(comp, Hashable) and comp in produced:
            produced[key] = produced[comp]
        else:
            produced[key] = ray_tpu_torch.put(comp)

    def materialize(k):
        if isinstance(k, list):
            return [materialize(x) for x in k]
        return ray_tpu_torch.get(produced[k])

    return materialize(list(keys) if isinstance(keys, list) else keys)
