"""The port's graftlint (``ray_tpu_torch/devtools/lint``): copies of the
JAX package's ``tests/test_lint.py``, names kept, run against the port's
copy of the analyzer.

Two layers:

- **fixture tests** — for every checker, a known-bad snippet that must
  be flagged and a known-good twin that must pass.  These pin the
  checker semantics so a refactor of the analyzer can't silently stop
  catching the bug class it was built for.  Fixture paths name
  ``ray_tpu_torch/...`` (the copy's allow-lists name the port's files)
  and the metrics catalog is ``docs/torch_observability.md``.
- **the gate** — ``ray_tpu_torch/`` itself must lint clean against the
  port's baseline ``tests/torch_graftlint.toml``, under the <30 s
  budget, with no stale baseline entries.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from ray_tpu_torch.devtools.lint import baseline as baseline_mod
from ray_tpu_torch.devtools.lint import core
from ray_tpu_torch.devtools.lint.cli import main as cli_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO_ROOT, "tests", "torch_graftlint.toml")


def lint_source(tmp_path, source, select, filename="mod.py", docs=None):
    """Write ``source`` into a scratch tree and run the selected checker.
    Returns the violations for that checker only (bad-suppression rides
    along when asked for explicitly)."""
    f = tmp_path / filename
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    if docs is not None:
        d = tmp_path / "docs" / "torch_observability.md"
        d.parent.mkdir(exist_ok=True)
        d.write_text(textwrap.dedent(docs))
    result = core.run_lint([str(f)], root=str(tmp_path), select=list(select))
    assert not result.parse_errors, result.parse_errors
    return result.violations


# ---------------------------------------------------------------- retry-gate

BAD_SLEEP_LOOP = """
    import time

    def wait_for_it(check):
        while not check():
            time.sleep(0.5)
"""

GOOD_POLICY_LOOP = """
    import time
    from ray_tpu_torch._private import retry

    def wait_for_it(check):
        bo = retry.POLL.start(deadline_s=30)
        while not check():
            delay = bo.next_delay()
            if delay is None:
                raise TimeoutError
            time.sleep(delay)
"""

BAD_HANDROLLED_RPC = """
    def fetch(client):
        while True:
            try:
                return client.call("get_thing")
            except ConnectionError:
                continue
"""

GOOD_IDEMPOTENT_RPC = """
    from ray_tpu_torch._private import rpc, retry

    def fetch(client):
        return rpc.call_idempotent(client, "get_thing", policy=retry.GCS_READ)
"""


def test_retry_gate_flags_fixed_sleep_loop(tmp_path):
    v = lint_source(tmp_path, BAD_SLEEP_LOOP, ["retry-gate"])
    assert [x.tag for x in v] == ["sleep=0.5"]
    assert v[0].symbol == "wait_for_it"


def test_retry_gate_passes_policy_loop(tmp_path):
    assert lint_source(tmp_path, GOOD_POLICY_LOOP, ["retry-gate"]) == []


def test_retry_gate_flags_handrolled_rpc_retry(tmp_path):
    v = lint_source(tmp_path, BAD_HANDROLLED_RPC, ["retry-gate"])
    assert [x.tag for x in v] == ["handrolled-rpc-retry"]


def test_retry_gate_passes_idempotent_call(tmp_path):
    assert lint_source(tmp_path, GOOD_IDEMPOTENT_RPC, ["retry-gate"]) == []


def test_retry_gate_ignores_yield_sleep(tmp_path):
    src = """
        import time

        def spin():
            while True:
                time.sleep(0)
    """
    assert lint_source(tmp_path, src, ["retry-gate"]) == []


# ---------------------------------------------------------------- lock-order

BAD_LOCK_CYCLE = """
    import threading

    a = threading.Lock()
    b = threading.Lock()

    def one():
        with a:
            with b:
                pass

    def two():
        with b:
            with a:
                pass
"""

GOOD_LOCK_ORDER = """
    import threading

    a = threading.Lock()
    b = threading.Lock()

    def one():
        with a:
            with b:
                pass

    def two():
        with a:
            with b:
                pass
"""

BAD_BLOCKING_UNDER_LOCK = """
    import threading
    import time

    class Pool:
        def __init__(self):
            self._mu = threading.Lock()

        def drain(self, client):
            with self._mu:
                client.call("flush")
"""

GOOD_BLOCKING_OUTSIDE_LOCK = """
    import threading
    import time

    class Pool:
        def __init__(self):
            self._mu = threading.Lock()

        def drain(self, client):
            with self._mu:
                todo = True
            if todo:
                client.call("flush")
"""


def test_lock_order_flags_cycle(tmp_path):
    v = lint_source(tmp_path, BAD_LOCK_CYCLE, ["lock-order"])
    cycles = [x for x in v if x.tag.startswith("cycle:")]
    assert len(cycles) == 1
    assert "potential deadlock" in cycles[0].message


def test_lock_order_passes_consistent_order(tmp_path):
    v = lint_source(tmp_path, GOOD_LOCK_ORDER, ["lock-order"])
    assert [x for x in v if x.tag.startswith("cycle:")] == []


def test_lock_order_flags_rpc_under_lock(tmp_path):
    v = lint_source(tmp_path, BAD_BLOCKING_UNDER_LOCK, ["lock-order"])
    assert len(v) == 1 and v[0].tag.startswith("blocking:rpc call@")
    assert v[0].symbol == "Pool.drain"


def test_lock_order_passes_rpc_outside_lock(tmp_path):
    assert lint_source(tmp_path, GOOD_BLOCKING_OUTSIDE_LOCK, ["lock-order"]) == []


def test_lock_order_closure_does_not_inherit_held_set(tmp_path):
    # A function *defined* under a lock does not *run* under it.
    src = """
        import threading
        import time

        mu = threading.Lock()

        def make_worker():
            with mu:
                def worker():
                    time.sleep(1.0)
                return worker
    """
    assert lint_source(tmp_path, src, ["lock-order"]) == []


# ----------------------------------------------------------- thread-lifecycle

BAD_ORPHAN_THREAD = """
    import threading

    class Loop:
        def start(self):
            self._t = threading.Thread(target=self._run)
            self._t.start()

        def _run(self):
            pass
"""

GOOD_JOINED_THREAD = BAD_ORPHAN_THREAD + """
        def stop(self):
            self._t.join()
"""

GOOD_DAEMON_THREAD = """
    import threading

    def fire_and_forget(fn):
        threading.Thread(target=fn, daemon=True).start()
"""


def test_thread_lifecycle_flags_orphan(tmp_path):
    v = lint_source(tmp_path, BAD_ORPHAN_THREAD, ["thread-lifecycle"])
    assert len(v) == 1 and v[0].tag == "handle=self._t"


def test_thread_lifecycle_passes_joined(tmp_path):
    assert lint_source(tmp_path, GOOD_JOINED_THREAD, ["thread-lifecycle"]) == []


def test_thread_lifecycle_passes_daemon(tmp_path):
    assert lint_source(tmp_path, GOOD_DAEMON_THREAD, ["thread-lifecycle"]) == []


# --------------------------------------------------------- blocking-in-handler

BAD_SLEEP_IN_HANDLER = """
    import time

    class Server:
        async def rpc_get_thing(self, req):
            self._settle()
            return {}

        def _settle(self):
            time.sleep(0.2)
"""

GOOD_ASYNC_SLEEP = """
    import asyncio

    class Server:
        async def rpc_get_thing(self, req):
            await asyncio.sleep(0.2)
            return {}
"""

BAD_SLEEP_IN_PUSH_CALLBACK = """
    import time

    class Watcher:
        def connect(self, make_client):
            self._client = make_client(on_push=self._on_push)

        def _on_push(self, msg):
            time.sleep(1.0)
"""


def test_blocking_handler_flags_sleep_via_helper(tmp_path):
    v = lint_source(tmp_path, BAD_SLEEP_IN_HANDLER, ["blocking-in-handler"])
    assert len(v) == 1
    assert v[0].symbol == "Server._settle"
    assert "rpc_get_thing" in v[0].tag


def test_blocking_handler_passes_async_sleep(tmp_path):
    assert lint_source(tmp_path, GOOD_ASYNC_SLEEP, ["blocking-in-handler"]) == []


def test_blocking_handler_flags_pubsub_callback(tmp_path):
    v = lint_source(tmp_path, BAD_SLEEP_IN_PUSH_CALLBACK, ["blocking-in-handler"])
    assert len(v) == 1 and v[0].symbol == "Watcher._on_push"


def test_blocking_handler_cross_module_helper_module(tmp_path):
    """A blocking call reached THROUGH a helper
    module (`from pkg import helper; helper.settle()`) must be caught —
    module-local analysis used to stop at the import boundary."""
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (tmp_path / "pkg" / "helper.py").write_text(textwrap.dedent("""
        import time

        def settle():
            time.sleep(0.2)
    """))
    (tmp_path / "pkg" / "server.py").write_text(textwrap.dedent("""
        from pkg import helper

        class Server:
            async def rpc_get_thing(self, req):
                helper.settle()
                return {}
    """))
    result = core.run_lint([str(tmp_path)], root=str(tmp_path),
                           select=["blocking-in-handler"])
    v = [x for x in result.violations if x.check == "blocking-in-handler"]
    assert len(v) == 1
    assert v[0].path == "pkg/helper.py" and v[0].symbol == "settle"
    assert "rpc_get_thing" in v[0].tag


def test_blocking_handler_cross_module_symbol_import(tmp_path):
    """`from pkg.helper import settle` direct-symbol imports resolve
    too, including constructor calls (`Class()` -> `Class.__init__`)."""
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (tmp_path / "pkg" / "helper.py").write_text(textwrap.dedent("""
        import time

        class SyncClient:
            def __init__(self):
                time.sleep(1.0)
    """))
    (tmp_path / "pkg" / "server.py").write_text(textwrap.dedent("""
        from pkg.helper import SyncClient

        class Server:
            async def rpc_connect(self, req):
                return SyncClient()
    """))
    result = core.run_lint([str(tmp_path)], root=str(tmp_path),
                           select=["blocking-in-handler"])
    v = [x for x in result.violations if x.check == "blocking-in-handler"]
    assert len(v) == 1
    assert v[0].symbol == "SyncClient.__init__"
    assert "rpc_connect" in v[0].tag


def test_blocking_handler_cross_module_clean_helper_passes(tmp_path):
    """A helper module with no blocking calls adds no findings."""
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (tmp_path / "pkg" / "helper.py").write_text(textwrap.dedent("""
        def settle():
            return 1 + 1
    """))
    (tmp_path / "pkg" / "server.py").write_text(textwrap.dedent("""
        from pkg import helper

        class Server:
            async def rpc_get_thing(self, req):
                return helper.settle()
    """))
    result = core.run_lint([str(tmp_path)], root=str(tmp_path),
                           select=["blocking-in-handler"])
    assert [x for x in result.violations if x.check == "blocking-in-handler"] == []


def test_blocking_handler_exempts_thread_target_closure(tmp_path):
    # The checker's own advice: defer blocking work to a worker thread.
    # The closure's sleep runs on that thread, not the dispatch loop.
    src = """
        import threading
        import time

        class Server:
            async def rpc_slow_op(self, req):
                def bg():
                    time.sleep(5.0)
                threading.Thread(target=bg, daemon=True).start()
                return {}
    """
    assert lint_source(tmp_path, src, ["blocking-in-handler"]) == []


# -------------------------------------------------------------- metrics-drift

CATALOG_ONLY_DOCUMENTED = """
    # Observability

    ## Metric catalog

    | name | type | tags | meaning |
    |---|---|---|---|
    | `documented_total` | counter | — | is in code and catalog |
"""

BAD_UNDOCUMENTED_METRIC = """
    from ray_tpu_torch.util.metrics import Counter

    documented = Counter("documented_total", description="fine")
    rogue = Counter("rogue_total", description="not in the catalog")
"""

CATALOG_WITH_ORPHAN = CATALOG_ONLY_DOCUMENTED + """\
    | `ghost_total` | counter | — | no code creates this |
"""

GOOD_IN_SYNC_METRIC = """
    from ray_tpu_torch.util.metrics import Counter

    documented = Counter("documented_total", description="fine")
"""

BAD_CARDINALITY_TAG = GOOD_IN_SYNC_METRIC + """
    def record(node_id):
        documented.inc(1, tags={"node": f"{node_id}"})
"""


def test_metrics_drift_flags_undocumented_instrument(tmp_path):
    v = lint_source(
        tmp_path, BAD_UNDOCUMENTED_METRIC, ["metrics-drift"],
        docs=CATALOG_ONLY_DOCUMENTED,
    )
    assert [x.tag for x in v] == ["undocumented:rogue_total"]


def test_metrics_drift_flags_orphaned_catalog_row(tmp_path):
    v = lint_source(
        tmp_path, GOOD_IN_SYNC_METRIC, ["metrics-drift"],
        docs=CATALOG_WITH_ORPHAN,
    )
    assert [x.tag for x in v] == ["orphaned:ghost_total"]
    assert v[0].path == "docs/torch_observability.md"


def test_metrics_drift_passes_in_sync(tmp_path):
    v = lint_source(
        tmp_path, GOOD_IN_SYNC_METRIC, ["metrics-drift"],
        docs=CATALOG_ONLY_DOCUMENTED,
    )
    assert v == []


def test_metrics_drift_flags_unbounded_cardinality(tmp_path):
    v = lint_source(
        tmp_path, BAD_CARDINALITY_TAG, ["metrics-drift"],
        docs=CATALOG_ONLY_DOCUMENTED,
    )
    assert [x.tag for x in v] == ["cardinality:node"]


# ------------------------------------------------------------- generation-key

# graftlint: disable=generation-key -- checker fixture: a deliberately hand-rolled generation string, the generation-key checker's known-bad twin
BAD_HANDROLLED_GEN_KEY = """
    def stash(kv, group, gen, rank, payload):
        kv.put(f"{group}/gen{gen}/{rank}", payload)
"""

# graftlint: disable=generation-key -- checker fixture: a deliberately hand-rolled generation string, the generation-key checker's known-bad twin
BAD_HANDROLLED_CKPT_DIR = """
    def resume_dir(base, gen, step, rank):
        return f"{base}/checkpoint_g{gen:03d}_{step:06d}_rank{rank}"
"""

# graftlint: disable=generation-key -- checker fixture: a generation string inside a docstring, the generation-key checker's known-good twin
GOOD_DESCRIBED_IN_DOCSTRING = '''
    def helper():
        """Keys look like <group>/gen<G>/<rank>; see cpu_group._key."""
        return None
'''


def test_generation_key_flags_handrolled_rendezvous_key(tmp_path):
    v = lint_source(tmp_path, BAD_HANDROLLED_GEN_KEY, ["generation-key"])
    assert len(v) == 1 and v[0].tag.startswith("rendezvous key:")


def test_generation_key_flags_handrolled_checkpoint_dir(tmp_path):
    v = lint_source(tmp_path, BAD_HANDROLLED_CKPT_DIR, ["generation-key"])
    assert len(v) == 1 and v[0].tag.startswith("checkpoint dir:")


def test_generation_key_exempts_docstrings(tmp_path):
    assert lint_source(tmp_path, GOOD_DESCRIBED_IN_DOCSTRING, ["generation-key"]) == []


def test_generation_key_exempts_canonical_module(tmp_path):
    # The same string inside the canonical helper module is the one
    # place allowed to build the format.
    v = lint_source(
        tmp_path, BAD_HANDROLLED_GEN_KEY, ["generation-key"],
        filename="ray_tpu_torch/util/collective/cpu_group.py",
    )
    assert v == []


# ---------------------------------------------------------------- trace-orphan

BAD_AMBIENT_RECORD_SPAN = """
    from ray_tpu_torch.util import tracing

    def on_frame(t0, t1):
        tracing.record_span("serve.replica.call", t0, t1, {"method": "f"})
"""

GOOD_EXPLICIT_FRAME_CONTEXT = """
    from ray_tpu_torch.util import tracing

    def on_frame(t0, t1, tctx):
        tracing.record_span(
            "serve.replica.call", t0, t1, {"method": "f"},
            context=(tctx[0], tracing.new_span_id(), tctx[1]),
        )
"""

GOOD_EXPLICIT_AMBIENT_CONTEXT = """
    from ray_tpu_torch.util import tracing

    def on_frame(t0, t1):
        tracing.record_span(
            "serve.replica.call", t0, t1, None,
            context=tracing.current_context(),
        )
"""

GOOD_EVENT_AND_START_SPAN = """
    from ray_tpu_torch.util import tracing

    def on_compile(t0, t1):
        tracing.record_event_span("jax.compile", t0, t1, {"fn": "step"})
        with tracing.start_span("serve.router", {"method": "f"}):
            pass
"""


def test_trace_orphan_flags_ambient_record_span(tmp_path):
    v = lint_source(tmp_path, BAD_AMBIENT_RECORD_SPAN, ["trace-orphan"])
    assert len(v) == 1 and v[0].check == "trace-orphan"
    assert "context=" in v[0].message


def test_trace_orphan_passes_explicit_frame_context(tmp_path):
    assert lint_source(tmp_path, GOOD_EXPLICIT_FRAME_CONTEXT, ["trace-orphan"]) == []


def test_trace_orphan_passes_explicit_ambient_context(tmp_path):
    # context=tracing.current_context() is the same read, stated.
    assert lint_source(tmp_path, GOOD_EXPLICIT_AMBIENT_CONTEXT, ["trace-orphan"]) == []


def test_trace_orphan_allows_event_and_start_span(tmp_path):
    assert lint_source(tmp_path, GOOD_EVENT_AND_START_SPAN, ["trace-orphan"]) == []


def test_trace_orphan_exempts_tracing_module(tmp_path):
    v = lint_source(
        tmp_path, BAD_AMBIENT_RECORD_SPAN, ["trace-orphan"],
        filename="ray_tpu_torch/util/tracing/__init__.py",
    )
    assert v == []


# ------------------------------------------------- suppressions and baseline

def test_inline_disable_with_reason_suppresses(tmp_path):
    src = """
        import time

        def cadence_loop():
            while True:
                # graftlint: disable=retry-gate -- fixed-cadence ticker, not a retry
                time.sleep(0.5)
    """
    v = lint_source(tmp_path, src, ["retry-gate"])
    assert len(v) == 1 and v[0].suppressed_by == "inline"


def test_inline_disable_without_reason_is_a_violation(tmp_path):
    # The reasonless marker is assembled via replace() so THIS file's raw
    # source doesn't itself scan as a reasonless disable (bad-suppression
    # deliberately can't be suppressed or baselined — tests/ is linted).
    src = """
        import time

        def cadence_loop():
            while True:
                time.sleep(0.5)  # graftlint: REASONLESS_DISABLE
    """.replace("REASONLESS_DISABLE", "disable=retry-gate")
    v = lint_source(tmp_path, src, ["retry-gate", "bad-suppression"])
    checks = sorted(x.check for x in v if x.suppressed_by is None)
    # The reasonless disable both fails to suppress and is itself flagged.
    assert checks == ["bad-suppression", "retry-gate"]


def test_baseline_round_trip(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(BAD_SLEEP_LOOP))
    found = core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    assert len(found.unsuppressed) == 1

    # write -> load -> apply: the same violation is now suppressed.
    bl_path = tmp_path / ".graftlint.toml"
    n = baseline_mod.write(str(bl_path), found.unsuppressed,
                           reason="fixture: accepted for the round-trip test")
    assert n == 1
    bl = baseline_mod.load(str(bl_path))
    again = core.run_lint([str(f)], root=str(tmp_path), baseline=bl,
                          select=["retry-gate"])
    assert again.unsuppressed == [] and len(again.suppressed) == 1
    assert again.unused_baseline == []

    # A baseline entry matching nothing is reported as stale.
    bl2 = baseline_mod.load(str(bl_path))
    bl2.entries[0].path = "nonexistent.py"
    stale = core.run_lint([str(f)], root=str(tmp_path), baseline=bl2,
                          select=["retry-gate"])
    assert len(stale.unsuppressed) == 1 and len(stale.unused_baseline) == 1


def test_inline_disable_star_suppresses_everything(tmp_path):
    src = """
        import time

        def cadence_loop():
            while True:
                time.sleep(0.5)  # graftlint: disable=* -- fixture: blanket opt-out
    """
    v = lint_source(tmp_path, src, ["retry-gate"])
    assert len(v) == 1 and v[0].suppressed_by == "inline"


def test_repo_root_fallback_is_a_directory(tmp_path):
    # No pyproject/.git/.graftlint.toml marker anywhere above tmp_path:
    # the starting directory (not the file) must become the root, so
    # violation relpaths stay real filenames and suppressions can match.
    f = tmp_path / "markerless.py"
    f.write_text(textwrap.dedent(BAD_SLEEP_LOOP))
    root = core.repo_root_for(str(f))
    if root == str(tmp_path):  # only meaningful when truly markerless
        result = core.run_lint([str(f)], select=["retry-gate"])
        assert [v.path for v in result.unsuppressed] == ["markerless.py"]


def test_baseline_rejects_malformed_toml(tmp_path):
    bl_path = tmp_path / ".graftlint.toml"
    bl_path.write_text('version = 1\n\n[[suppress]]\ncheck = [unclosed\n')
    with pytest.raises(baseline_mod.BaselineError):
        baseline_mod.load(str(bl_path))


def test_baseline_rejects_reasonless_entry(tmp_path):
    bl_path = tmp_path / ".graftlint.toml"
    bl_path.write_text(
        'version = 1\n\n[[suppress]]\ncheck = "retry-gate"\npath = "x.py"\n'
    )
    with pytest.raises(baseline_mod.BaselineError, match="reason"):
        baseline_mod.load(str(bl_path))


# -------------------------------------------------------------- the real gate

# ------------------------------------------------------------ import-cycle


def _lint_tree(tmp_path, files, select):
    for rel, src in files.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    result = core.run_lint([str(tmp_path)], root=str(tmp_path), select=list(select))
    assert not result.parse_errors, result.parse_errors
    return result.violations


def test_import_cycle_module_level_flagged(tmp_path):
    v = _lint_tree(
        tmp_path,
        {
            "pkg/__init__.py": "",
            "pkg/a.py": "import pkg.b\n",
            "pkg/b.py": "from pkg import a\n",
        },
        ["import-cycle"],
    )
    assert len(v) == 1, [x.format() for x in v]
    assert "pkg.a" in v[0].message and "pkg.b" in v[0].message
    # Identity tag is the sorted member list: stable across line drift.
    assert v[0].tag == "cycle:pkg.a>pkg.b"


def test_import_cycle_function_local_is_clean(tmp_path):
    """The house convention: breaking a cycle with a function-local
    import must satisfy the checker (imports inside functions don't run
    at import time)."""
    v = _lint_tree(
        tmp_path,
        {
            "pkg/__init__.py": "",
            "pkg/a.py": "import pkg.b\n",
            "pkg/b.py": "def f():\n    from pkg import a\n    return a\n",
        },
        ["import-cycle"],
    )
    assert v == [], [x.format() for x in v]


def test_import_cycle_type_checking_guard_is_clean(tmp_path):
    v = _lint_tree(
        tmp_path,
        {
            "pkg/__init__.py": "",
            "pkg/a.py": "import pkg.b\n",
            "pkg/b.py": (
                "from typing import TYPE_CHECKING\n"
                "if TYPE_CHECKING:\n    import pkg.a\n"
            ),
        },
        ["import-cycle"],
    )
    assert v == [], [x.format() for x in v]


def test_import_cycle_three_module_loop_single_violation(tmp_path):
    v = _lint_tree(
        tmp_path,
        {
            "pkg/__init__.py": "",
            "pkg/a.py": "import pkg.b\n",
            "pkg/b.py": "import pkg.c\n",
            "pkg/c.py": "import pkg.a\n",
        },
        ["import-cycle"],
    )
    assert len(v) == 1
    assert v[0].tag == "cycle:pkg.a>pkg.b>pkg.c"


def test_metrics_drift_wildcard_family_row_covers_instruments(tmp_path):
    """A catalog family row (test_*) covers literal instruments matching
    it — no per-instrument row needed."""
    docs = """
        # obs

        ## Metric catalog

        | name | type | tags | meaning |
        |---|---|---|---|
        | `test_*` | any | any | test-only family |
    """
    v = lint_source(
        tmp_path,
        """
        from ray_tpu_torch.util import metrics as m

        c = m.Counter("test_requests_total", "test counter")
        """,
        ["metrics-drift"],
        docs=docs,
    )
    assert v == [], [x.format() for x in v]


def test_graftlint_gate_repo_is_clean():
    """THE tier-1 gate: ray_tpu_torch/ lints clean against the port's
    baseline, inside the budget, with no stale entries."""
    bl = baseline_mod.load(BASELINE)
    for e in bl.entries:
        assert e.reason.strip(), f"baseline entry without a reason: {e}"
        assert not e.reason.lower().startswith("todo"), (
            f"placeholder reason in checked-in baseline: {e}"
        )
    result = core.run_lint(
        [os.path.join(REPO_ROOT, "ray_tpu_torch")],
        root=REPO_ROOT,
        baseline=bl,
    )
    assert result.parse_errors == []
    assert result.unsuppressed == [], "\n".join(
        v.format() for v in result.unsuppressed
    )
    assert result.unused_baseline == [], (
        f"stale baseline entries: {result.unused_baseline}"
    )
    assert result.files_checked > 100  # the walk really covered the tree
    assert result.elapsed_s < 30.0


def test_graftlint_cli_entrypoint():
    """`python -m ray_tpu_torch.devtools.lint ray_tpu_torch --strict
    --baseline tests/torch_graftlint.toml` exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", "ray_tpu_torch",
         "--strict", "--baseline", BASELINE],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_graftlint_cli_select_and_exit_code(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text(textwrap.dedent(BAD_SLEEP_LOOP))
    rc = cli_main([str(f), "--root", str(tmp_path), "--select", "retry-gate"])
    assert rc == 1
    rc = cli_main([str(f), "--root", str(tmp_path), "--select", "thread-lifecycle"])
    assert rc == 0
    assert cli_main(["--list-checks"]) == 0
    assert cli_main([str(f), "--select", "not-a-check"]) == 2


# ------------------------------------------------------------ rpc-contract

SERVER_WITH_PING = """
    class Server:
        async def rpc_ping(self, payload, conn):
            return "pong"
"""

BAD_RPC_TYPO = {
    "server.py": SERVER_WITH_PING,
    "client.py": """
        def use(client):
            client.call("ping", None)
            return client.call("pingg", None)
    """,
}

GOOD_RPC_WIRED = {
    "server.py": SERVER_WITH_PING,
    "client.py": """
        def use(client):
            return client.call("ping", None)
    """,
}

BAD_RPC_DEAD_ENDPOINT = {
    "server.py": """
        class Server:
            async def rpc_ping(self, payload, conn):
                return "pong"

            async def rpc_orphan(self, payload, conn):
                return 1
    """,
    "client.py": """
        def use(client):
            return client.call("ping", None)
    """,
}

BAD_PAYLOAD_DRIFT = {
    "server.py": """
        class Server:
            async def rpc_report(self, payload, conn):
                a = payload["node_id"]
                b = payload["available"]
                return a, b
    """,
    "client.py": """
        def use(client):
            return client.call("report", {"node_id": b"n"})
    """,
}

GOOD_PAYLOAD_COMPLETE = {
    "server.py": """
        class Server:
            async def rpc_report(self, payload, conn):
                a = payload["node_id"]
                b = payload["available"]
                c = payload.get("total")
                return a, b, c
    """,
    "client.py": """
        def use(client):
            return client.call("report", {"node_id": b"n", "available": {}})
    """,
}

BAD_RETRY_UNSAFE = {
    "server.py": """
        class Server:
            async def rpc_bump(self, payload, conn):
                self.n += payload["delta"]
                return self.n
    """,
    "client.py": """
        from ray_tpu_torch._private.rpc import call_idempotent

        def use(client):
            return call_idempotent(client, "bump", {"delta": 1})
    """,
}

GOOD_RETRY_READONLY = {
    "server.py": '''
        class Server:
            async def rpc_peek(self, payload, conn):
                """rpc-contract: read-only -- lookup only."""
                return self.n
    ''',
    "client.py": """
        from ray_tpu_torch._private.rpc import call_idempotent

        def use(client):
            return call_idempotent(client, "peek", None)
    """,
}

GOOD_RETRY_TOKEN = {
    "server.py": """
        class Server:
            async def rpc_bump(self, payload, conn):
                tok = payload["token"]
                if tok in self.seen:
                    return self.n
                self.seen.add(tok)
                self.n += payload["delta"]
                return self.n
    """,
    "client.py": """
        from ray_tpu_torch._private.rpc import call_idempotent

        def use(client):
            return call_idempotent(client, "bump", {"delta": 1, "token": "t1"})
    """,
}

BAD_FENCE_MISSING = {
    "server.py": """
        class Gcs:
            def _check_fence(self, method, node_id, incarnation):
                raise NotImplementedError

            async def rpc_heartbeat(self, payload, conn):
                node_id = payload["node_id"]
                self.last_seen[node_id] = 1
                return True
    """,
    "client.py": """
        def use(client):
            return client.call("heartbeat", {"node_id": b"n", "incarnation": 1})
    """,
}

GOOD_FENCE_FIRST = {
    "server.py": """
        class Gcs:
            def _check_fence(self, method, node_id, incarnation):
                raise NotImplementedError

            async def rpc_heartbeat(self, payload, conn):
                node_id = payload["node_id"]
                self._check_fence("heartbeat", node_id, payload.get("incarnation"))
                self.last_seen[node_id] = 1
                return True
    """,
    "client.py": """
        def use(client):
            return client.call("heartbeat", {"node_id": b"n", "incarnation": 1})
    """,
}


def test_rpc_contract_flags_typo_endpoint(tmp_path):
    v = _lint_tree(tmp_path, BAD_RPC_TYPO, ["rpc-contract"])
    assert [x.tag for x in v] == ["no-handler:method=pingg"], [x.format() for x in v]


def test_rpc_contract_passes_wired_endpoint(tmp_path):
    assert _lint_tree(tmp_path, GOOD_RPC_WIRED, ["rpc-contract"]) == []


def test_rpc_contract_flags_dead_endpoint(tmp_path):
    v = _lint_tree(tmp_path, BAD_RPC_DEAD_ENDPOINT, ["rpc-contract"])
    assert [x.tag for x in v] == ["dead-endpoint:method=orphan"], [x.format() for x in v]
    assert v[0].symbol == "Server.rpc_orphan"


def test_rpc_contract_flags_payload_key_drift(tmp_path):
    v = _lint_tree(tmp_path, BAD_PAYLOAD_DRIFT, ["rpc-contract"])
    assert [x.tag for x in v] == ["payload-drift:method=report:missing=available"]
    assert v[0].path == "client.py"  # flagged at the call site


def test_rpc_contract_passes_complete_payload(tmp_path):
    # .get()-guarded keys are optional: only bare subscripts are required.
    assert _lint_tree(tmp_path, GOOD_PAYLOAD_COMPLETE, ["rpc-contract"]) == []


def test_rpc_contract_flags_retry_unsafe_idempotent_call(tmp_path):
    v = _lint_tree(tmp_path, BAD_RETRY_UNSAFE, ["rpc-contract"])
    assert [x.tag for x in v] == ["retry-unsafe:method=bump"], [x.format() for x in v]


def test_rpc_contract_passes_declared_read_only(tmp_path):
    assert _lint_tree(tmp_path, GOOD_RETRY_READONLY, ["rpc-contract"]) == []


def test_rpc_contract_passes_token_consuming_handler(tmp_path):
    assert _lint_tree(tmp_path, GOOD_RETRY_TOKEN, ["rpc-contract"]) == []


def test_rpc_contract_flags_fence_missing(tmp_path):
    v = _lint_tree(tmp_path, BAD_FENCE_MISSING, ["rpc-contract"])
    assert [x.tag for x in v] == ["fence-missing:method=heartbeat"], [x.format() for x in v]
    assert v[0].symbol == "Gcs.rpc_heartbeat"


def test_rpc_contract_passes_fence_before_write(tmp_path):
    assert _lint_tree(tmp_path, GOOD_FENCE_FIRST, ["rpc-contract"]) == []


# -------------------------------------------------------- shared-state-race

BAD_CROSS_THREAD_UNLOCKED = """
    import threading

    class Pump:
        def __init__(self):
            self.items = []
            self._lock = threading.Lock()
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            while True:
                self.items.append(1)

        def drain(self):
            return list(self.items)
"""

GOOD_LOCKED_TWIN = """
    import threading

    class Pump:
        def __init__(self):
            self.items = []
            self._lock = threading.Lock()
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            while True:
                with self._lock:
                    self.items.append(1)

        def drain(self):
            with self._lock:
                return list(self.items)
"""

GOOD_SINGLE_WRITER_FLAG = """
    import threading

    class Task:
        def __init__(self):
            self._done = False
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            self._done = True

        def poll(self):
            return self._done
"""

GOOD_QUEUE_HANDOFF = """
    import queue
    import threading

    class Pump:
        def __init__(self):
            self.q: "queue.Queue" = queue.Queue()
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            while True:
                self.q.put(1)

        def drain(self):
            return self.q.get()
"""

GOOD_MANUAL_ACQUIRE = """
    import threading

    class Pump:
        def __init__(self):
            self.items = []
            self._lock = threading.Lock()
            threading.Thread(target=self._run, daemon=True).start()

        def _run(self):
            with self._lock:
                self.items.append(1)

        def drain(self):
            if not self._lock.acquire(blocking=False):
                return []
            try:
                return list(self.items)
            finally:
                self._lock.release()
"""


def test_shared_state_race_flags_cross_thread_unlocked_write(tmp_path):
    v = lint_source(tmp_path, BAD_CROSS_THREAD_UNLOCKED, ["shared-state-race"])
    assert [x.tag for x in v] == ["attr=Pump.items"], [x.format() for x in v]
    assert v[0].symbol == "Pump"


def test_shared_state_race_passes_locked_twin(tmp_path):
    assert lint_source(tmp_path, GOOD_LOCKED_TWIN, ["shared-state-race"]) == []


def test_shared_state_race_passes_single_writer_flag(tmp_path):
    assert lint_source(tmp_path, GOOD_SINGLE_WRITER_FLAG, ["shared-state-race"]) == []


def test_shared_state_race_passes_queue_handoff(tmp_path):
    assert lint_source(tmp_path, GOOD_QUEUE_HANDOFF, ["shared-state-race"]) == []


def test_shared_state_race_passes_try_finally_release(tmp_path):
    assert lint_source(tmp_path, GOOD_MANUAL_ACQUIRE, ["shared-state-race"]) == []


def test_shared_state_race_skips_tests_tree(tmp_path):
    f = tmp_path / "tests" / "test_thing.py"
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(BAD_CROSS_THREAD_UNLOCKED))
    result = core.run_lint([str(f)], root=str(tmp_path),
                           select=["shared-state-race"])
    assert result.violations == []


# --------------------------------------------------- json output + ast cache


def test_graftlint_json_output(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text(textwrap.dedent(BAD_SLEEP_LOOP))
    import json as json_mod

    rc = cli_main([str(f), "--root", str(tmp_path), "--json"])
    assert rc == 1
    report = json_mod.loads(capsys.readouterr().out)
    assert report["unsuppressed"] == 1
    assert report["by_check"]["retry-gate"] == 1
    assert report["by_check"]["rpc-contract"] == 0
    assert set(report["checks_run"]) >= {"rpc-contract", "shared-state-race"}
    assert report["cache"]["hits"] + report["cache"]["misses"] == 1
    v = report["violations"][0]
    assert v["check"] == "retry-gate" and v["path"] == "bad.py"


def test_ast_cache_hits_on_second_run(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(GOOD_POLICY_LOOP))
    first = core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    assert (first.cache_hits, first.cache_misses) == (0, 1)
    second = core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    assert (second.cache_hits, second.cache_misses) == (1, 0)
    # Same verdict either way.
    assert second.violations == first.violations

    # An edit changes the content hash: clean miss, fresh tree, and the
    # new violation is seen (a stale cache would hide it).
    f.write_text(textwrap.dedent(BAD_SLEEP_LOOP))
    third = core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    assert third.cache_misses == 1
    assert len(third.unsuppressed) == 1


def test_ast_cache_survives_corrupt_entry(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(GOOD_POLICY_LOOP))
    core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    cache_dir = tmp_path / ".graftlint_cache"
    entries = list(cache_dir.iterdir())
    assert entries, "cache dir is empty after a miss"
    for e in entries:
        e.write_bytes(b"not a pickle")
    result = core.run_lint([str(f)], root=str(tmp_path), select=["retry-gate"])
    assert result.parse_errors == []
    assert result.cache_misses == 1  # fell back to a fresh parse


def test_ast_cache_disabled_flag(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(GOOD_POLICY_LOOP))
    result = core.run_lint([str(f)], root=str(tmp_path),
                           select=["retry-gate"], use_cache=False)
    assert (result.cache_hits, result.cache_misses) == (0, 0)
    assert not (tmp_path / ".graftlint_cache").exists()
