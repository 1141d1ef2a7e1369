"""Lazy task/actor DAGs (reference: python/ray/dag/ — FunctionNode,
ClassMethodNode, InputNode/MultiOutputNode; compiled execution
dag/compiled_dag_node.py:694).

`fn.bind(x)` builds nodes instead of launching tasks; `node.execute(v)`
materializes one run.  `experimental_compile()` freezes the graph into a
static per-actor schedule: actors are instantiated once and execution
switches to mutable channels written in place per call with resident
per-actor op loops — no task submission, no object store, no RPC on the
steady-state path (reference: compiled_dag_node.py:1639 schedules +
experimental_mutable_object_manager.h:48 channels).  Channel transport
is selected per edge at compile time by placement: same-node edges ride
mmap'd seqlock rings, cross-node edges one persistent socket each, so
the same compiled graph spans hosts.  Driver-side FunctionNodes are
compiled into resident executor actors too; only graphs using features
the op schedule can't express (kwargs, exotic arg nodes) keep the
per-node task path.  Values move in the binary wire format
(_private/wire.py): zero pickling and zero intermediate copies for
small args/results."""

from __future__ import annotations

import os
import threading
import uuid
from typing import Any, Dict, List, Optional

__all__ = [
    "DAGNode",
    "InputNode",
    "InputAttributeNode",
    "FunctionNode",
    "ClassNode",
    "ClassMethodNode",
    "MultiOutputNode",
    "bind_function",
    "bind_actor_class",
]


class DAGNode:
    def __init__(self, args: tuple = (), kwargs: Optional[dict] = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}
        self._stable_uuid = uuid.uuid4().hex

    # -- traversal -------------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _topo(self) -> List["DAGNode"]:
        seen: Dict[str, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if node._stable_uuid in seen:
                return
            seen[node._stable_uuid] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    # -- execution -------------------------------------------------------
    def execute(self, *input_vals, _compiled_ctx: Optional[dict] = None) -> Any:
        """Run the whole DAG once; returns ObjectRef(s) of this node."""
        ctx = _compiled_ctx if _compiled_ctx is not None else {}
        input_val = input_vals[0] if len(input_vals) == 1 else (input_vals if input_vals else None)
        cache: Dict[str, Any] = {}
        for node in self._topo():
            cache[node._stable_uuid] = node._execute_one(cache, input_val, ctx)
        return cache[self._stable_uuid]

    def _resolve(self, cache, val):
        if isinstance(val, DAGNode):
            return cache[val._stable_uuid]
        return val

    def _execute_one(self, cache: dict, input_val, ctx: dict):
        raise NotImplementedError

    def experimental_compile(
        self, buffer_size_bytes: int = 8 * 1024 * 1024, max_inflight: int = 4
    ) -> "CompiledDAG":
        return CompiledDAG(self, buffer_size_bytes, max_inflight)


class InputNode(DAGNode):
    """`with InputNode() as inp:` — placeholder for execute()'s argument."""

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def _execute_one(self, cache, input_val, ctx):
        return input_val


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((parent,))
        self._key = key

    def _execute_one(self, cache, input_val, ctx):
        base = cache[self._bound_args[0]._stable_uuid]
        if isinstance(self._key, str) and isinstance(base, dict):
            return base[self._key]
        if isinstance(self._key, int):
            return base[self._key]
        return getattr(base, self._key)


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_one(self, cache, input_val, ctx):
        args = [self._resolve(cache, a) for a in self._bound_args]
        kwargs = {k: self._resolve(cache, v) for k, v in self._bound_kwargs.items()}
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """ActorClass.bind(...) — instantiated per execution, or once when
    compiled (the reference's model: compiled DAGs pin their actors)."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls

    def _execute_one(self, cache, input_val, ctx):
        actors = ctx.setdefault("actors", {})
        if self._stable_uuid not in actors:
            args = [self._resolve(cache, a) for a in self._bound_args]
            kwargs = {k: self._resolve(cache, v) for k, v in self._bound_kwargs.items()}
            actors[self._stable_uuid] = self._actor_cls.remote(*args, **kwargs)
        return actors[self._stable_uuid]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__((class_node,) + tuple(args), kwargs)
        self._method = method

    def _execute_one(self, cache, input_val, ctx):
        actor = cache[self._bound_args[0]._stable_uuid]
        args = [self._resolve(cache, a) for a in self._bound_args[1:]]
        kwargs = {k: self._resolve(cache, v) for k, v in self._bound_kwargs.items()}
        return getattr(actor, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs))

    def _execute_one(self, cache, input_val, ctx):
        return [cache[n._stable_uuid] for n in self._bound_args]


class _FnExecutor:
    """Resident executor hosting a compiled driver-side FunctionNode
    (reference: compiled graphs pin every computation to a long-lived
    worker).  One per FunctionNode (num_cpus=0) so independent function
    branches overlap instead of serializing through one process; the op
    loop calls ``self._dag_fns[op["fn"]]``."""

    def __init__(self, fn_blob: bytes):
        from ray_tpu_torch._private import serialization

        self._dag_fns = [serialization.loads_function(fn_blob)]


def _ring_dir(token: str) -> str:
    """Per-DAG ring directory, same path on every node of the cluster
    (tmpfs when available).  Channel ids are unique across the DAG, so
    two nodes of one machine sharing /dev/shm can't collide."""
    from ray_tpu_torch.experimental.channel import ring_base_dir

    return os.path.join(ring_base_dir(), f"ray_tpu_torch_dag_{token}")


def _dag_probe(self):
    """Runs inside a compiled actor: placement probe for compile-time
    channel-transport selection."""
    from ray_tpu_torch._private.worker import get_global_worker

    w = get_global_worker()
    return w.node_id.hex() if w.node_id is not None else ""


def _dag_setup(self, token, ring_creates, socket_binds, buffer_size):
    """Runs inside a compiled actor, BEFORE any loop starts: the reader
    side of every edge creates its ring files / binds its socket
    listeners, so writers (which dial / open at loop start) never race a
    missing endpoint.  Returns {channel_id: bound port}."""
    from ray_tpu_torch.experimental import channel as channel_mod

    d = _ring_dir(token)
    if ring_creates:
        os.makedirs(d, exist_ok=True)
    for cid in ring_creates:
        channel_mod.Channel.create_file(os.path.join(d, cid), buffer_size)
    return {cid: channel_mod.bind_listener(token, cid) for cid in socket_binds}


def _actor_channel_loop(self, ops, descs, token):
    """Runs INSIDE a compiled DAG's actor (via __ray_call__): a frozen
    per-actor op schedule reading args from in-channels and local
    results, writing cross-process results to out-channels (reference:
    compiled_dag_node.py:1639 per-actor op schedules executing over
    preallocated channels).

    Graph-level scheduling: writers DIAL all their socket edges first
    (listeners are pre-bound in the setup phase, so dials never block on
    a peer's accept), and multi-out results fan out with round-robin
    try-writes so one slow consumer never head-of-line-blocks an
    independent branch.

    Application errors do NOT kill the loop: the error is serialized and
    flows through the op's out-channels like a result (downstream ops
    see it, skip execution, and propagate), so the driver's get raises
    the original exception and the DAG stays usable."""
    import shutil
    import time as _time

    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private import serialization, telemetry
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.experimental import channel as channel_mod
    from ray_tpu_torch.experimental.channel import ChannelClosed
    from ray_tpu_torch.util import tracing

    read_ids, write_ids = set(), set()
    for op in ops:
        for kind, val in op["args"]:
            if kind == "chan":
                read_ids.add(val)
        write_ids.update(op["outs"])
    chans = {}
    try:
        for cid in sorted(write_ids):
            chans[cid] = channel_mod.open_channel(
                descs[cid], "write", timeout=CONFIG.dag_socket_connect_timeout_s
            )
        for cid in sorted(read_ids):
            chans[cid] = channel_mod.open_channel(descs[cid], "read")
    except Exception:
        channel_mod.drop_listeners(token)
        raise
    TAG_ERROR = serialization.TAG_ERROR
    TAG_BATCH = serialization.TAG_BATCH

    def read_arg(cid):
        """One channel-arg read with the dataplane fault contract: a
        connection-level death takes one shared reattach() attempt
        before tearing the loop down.  A corrupted frame FAILS CLOSED
        (loop teardown, driver sees typed ChannelClosed): its
        multiplicity is unknowable — it may have been a TAG_BATCH frame
        carrying K executions — so emitting any fixed number of error
        values would desync the per-edge FIFO and deliver later
        executions' results to the wrong refs."""
        while True:
            try:
                return chans[cid].read_value_traced(timeout=None)
            except ChannelClosed:
                if not channel_mod.reattach(chans[cid]):
                    raise

    def run_op(op, args):
        """One op execution; returns (result, tag) — errors become
        values that flow downstream like results."""
        try:
            t0 = _time.perf_counter()
            if "fn" in op:
                result = self._dag_fns[op["fn"]](*args)
            else:
                result = getattr(self, op["method"])(*args)
            telemetry.observe_dag_op(op["method"], _time.perf_counter() - t0)
            return result, serialization.TAG_NORMAL
        except ChannelClosed:
            raise
        except Exception as e:  # noqa: BLE001
            return (
                exceptions.RayTaskError.from_exception(
                    e, f"compiled_dag.{op['method']}"
                ),
                TAG_ERROR,
            )

    try:
        while True:
            local = {}
            local_batched = set()  # uuids whose local result is a K-list
            # Trace context of each op's recorded dag.op span, so ops fed
            # only by "local" args still chain under the execution that
            # produced their input.
            local_ctx = {}
            for op in ops:
                args = []
                arg_error = None
                batch_k = None  # execute_many: K executions in one frame
                frame_ctx = None  # first traced inbound frame this op saw
                for kind, val in op["args"]:
                    if kind == "chan":
                        tag, v, tctx = read_arg(val)
                        if tctx is not None and frame_ctx is None:
                            frame_ctx = tctx
                        if tag == TAG_BATCH:
                            batch_k = len(v)
                        elif tag == TAG_ERROR:
                            arg_error = v
                        args.append((tag == TAG_BATCH, v))
                    elif kind == "local":
                        v = local[val]
                        if frame_ctx is None:
                            frame_ctx = local_ctx.get(val)
                        if val in local_batched:
                            batch_k = len(v)
                            args.append((True, v))
                        else:
                            if isinstance(v, exceptions.RayTaskError):
                                arg_error = v
                            args.append((False, v))
                    else:  # const
                        args.append((False, val))
                # Re-parent THIS execution from the inbound frame context.
                # The loop runs inside one long-lived task whose context
                # was installed once at actor start; without the per-
                # execution re-parent every span recorded inside resident
                # executors chained to that stale context.  An untraced
                # frame (frame_ctx None) CLEARS the context for the same
                # reason.
                ftok = tracing.set_frame_context(frame_ctx)
                t_op = _time.time()
                try:
                    if batch_k is not None:
                        # K executions amortized into one channel write per
                        # edge: scalars (consts) broadcast, per-entry errors
                        # stay entries (downstream skips only their slot).
                        results = []
                        for k in range(batch_k):
                            item_args = [v[k] if b else v for b, v in args]
                            err = next(
                                (
                                    a
                                    for a in item_args
                                    if isinstance(a, exceptions.RayTaskError)
                                ),
                                None,
                            )
                            if err is not None:
                                results.append(err)
                            else:
                                results.append(run_op(op, item_args)[0])
                        local[op["uuid"]] = results
                        local_batched.add(op["uuid"])
                        if frame_ctx is not None:
                            local_ctx[op["uuid"]] = tracing.current_context()
                        if op["outs"]:
                            channel_mod.write_value_fanout(
                                [(chans[o], results, TAG_BATCH) for o in op["outs"]],
                                timeout=None,
                            )
                        continue
                    plain_args = [v for _b, v in args]
                    if arg_error is not None:
                        result, tag = arg_error, TAG_ERROR
                    else:
                        result, tag = run_op(op, plain_args)
                    local[op["uuid"]] = result
                    if frame_ctx is not None:
                        local_ctx[op["uuid"]] = tracing.current_context()
                    if op["outs"]:
                        channel_mod.write_value_fanout(
                            [(chans[o], result, tag) for o in op["outs"]],
                            timeout=None,
                        )
                finally:
                    if frame_ctx is not None:
                        tracing.record_span(
                            "dag.op",
                            t_op,
                            _time.time(),
                            {"method": op["method"], "batch_k": batch_k or 1},
                            context=tracing.current_context(),
                        )
                    tracing.reset_context(ftok)
    except (ChannelClosed, channel_mod.ChannelCorruptionError):
        # Teardown (orderly close, or fail-closed frame corruption):
        # propagate the poison downstream so every consumer (other
        # actor loops, the driver) unblocks, then reclaim local
        # endpoints + this node's ring directory.
        for c in chans.values():
            try:
                c.close()
            except Exception:
                pass
        shutil.rmtree(_ring_dir(token), ignore_errors=True)
        return "closed"


# Process-wide in-flight count across ALL CompiledDAGs: the exported
# dag_inflight gauge is per process (last-writer-wins at the registry),
# so two concurrently-driven DAGs must contribute to one aggregate
# instead of overwriting each other's occupancy.
_inflight_lock = threading.Lock()
_inflight_total = 0


def _inflight_adjust(delta: int) -> None:
    global _inflight_total
    from ray_tpu_torch._private import telemetry

    with _inflight_lock:
        _inflight_total = max(0, _inflight_total + delta)
        total = _inflight_total
    telemetry.set_dag_inflight(total)


class CompiledDAGRef:
    """Result handle of one compiled execution; resolved by ray_tpu_torch.get
    (reference: CompiledDAGRef in dag/compiled_dag_node.py)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None):
        return self._dag._read_result(self._seq, timeout)


class CompiledDAG:
    """Static schedule + pinned actors (reference:
    dag/compiled_dag_node.py:694 — per-actor op schedules :1639,
    execute :2118).

    Execution runs on the zero-copy data plane for any graph the op
    schedule can express: one mutable channel per cross-process edge
    (mmap ring same-node, persistent socket cross-node — chosen at
    compile time from actor placement), written in place every
    execution, with each actor running its frozen op schedule in a
    resident loop — no task submission, no object store, no RPC per
    call (reference: experimental_mutable_object_manager.h:48).
    Driver-side FunctionNodes compile into resident _FnExecutor actors.
    Graphs using kwargs or arg nodes outside the schedule's vocabulary
    fall back to per-node task submission."""

    def __init__(
        self,
        root: DAGNode,
        buffer_size_bytes: int = 8 * 1024 * 1024,
        max_inflight: int = 4,
    ):
        self._root = root
        self._order = root._topo()  # frozen schedule
        self._ctx: dict = {"actors": {}}
        # instantiate all actors up front
        cache: Dict[str, Any] = {}
        for node in self._order:
            if isinstance(node, ClassNode):
                node._execute_one(cache, None, self._ctx)
        self._lock = threading.Lock()
        self._seq = 0
        self._results: Dict[int, Any] = {}
        self._next_result = 1
        # This DAG's live contribution to the process-wide dag_inflight
        # gauge (returned on drain or at teardown, so an abandoned DAG
        # can't pin the gauge elevated forever).
        self._inflight_contrib = 0
        self._out_pending: List[Any] = []  # populated at channel-plan build
        self._channels_on = False
        self._buffer_size = buffer_size_bytes
        # Flow control: the driver-side cap on executions submitted
        # before a get (reference: max_inflight_executions).  The
        # channels themselves carry many in-flight messages (ring free
        # space / socket unacked window), so this is the only limit a
        # pipelined driver sees.
        self._max_inflight = max_inflight
        try:
            self._build_channel_plan(cache)
        except _NotChannelable:
            pass

    # -- channel compilation -------------------------------------------
    def _validate_channelable(self) -> List[DAGNode]:
        """All _NotChannelable decisions happen HERE, before any executor
        actor is created, so a fallback graph never leaks actors."""
        method_nodes: List[DAGNode] = []
        for n in self._order:
            if isinstance(n, (InputNode, InputAttributeNode, ClassNode, MultiOutputNode)):
                continue
            if isinstance(n, (ClassMethodNode, FunctionNode)):
                if n._bound_kwargs:
                    raise _NotChannelable  # kwargs not in the op schedule
                if isinstance(n, FunctionNode) and getattr(n._remote_fn, "_function", None) is None:
                    raise _NotChannelable
                data_args = (
                    n._bound_args[1:]
                    if isinstance(n, ClassMethodNode)
                    else n._bound_args
                )
                for arg in data_args:
                    if isinstance(arg, DAGNode) and not isinstance(
                        arg, (InputNode, InputAttributeNode, ClassMethodNode, FunctionNode)
                    ):
                        raise _NotChannelable
                method_nodes.append(n)
            else:
                raise _NotChannelable
        if not method_nodes:
            raise _NotChannelable
        outputs = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode)
            else [self._root]
        )
        if not all(isinstance(o, (ClassMethodNode, FunctionNode)) for o in outputs):
            raise _NotChannelable
        return method_nodes

    @staticmethod
    def _node_hosts(worker) -> Dict[str, str]:
        from ray_tpu_torch.experimental.channel import node_hosts

        return node_hosts(worker)

    def _build_channel_plan(self, actor_cache: Dict[str, Any]):
        import ray_tpu_torch
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch._private.worker import get_global_worker
        from ray_tpu_torch.experimental import channel as channel_mod

        method_nodes = self._validate_channelable()
        outputs = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode)
            else [self._root]
        )

        # Driver-side FunctionNodes become resident executor actors so
        # the whole graph lives on the channel plane (they previously
        # forced the per-call task path).
        from ray_tpu_torch.actor import ActorClass

        actor_of: Dict[str, str] = {}
        for n in method_nodes:
            if isinstance(n, ClassMethodNode):
                actor_of[n._stable_uuid] = n._bound_args[0]._stable_uuid
            else:
                executor = ActorClass(_FnExecutor, {"num_cpus": 0}).remote(
                    serialization.dumps_function(n._remote_fn._function)
                )
                self._ctx["actors"][n._stable_uuid] = executor
                actor_of[n._stable_uuid] = n._stable_uuid

        # Placement probe: transport per edge is chosen by node identity
        # (separate raylets on one machine are distinct "hosts" — the
        # conservative direction: sockets always work, rings need a
        # shared raylet).
        actors = self._ctx["actors"]
        live_actor_uuids = sorted(set(actor_of.values()))
        probe_refs = {
            a: actors[a].__ray_call__.remote(_dag_probe) for a in live_actor_uuids
        }
        node_of_actor = {a: ray_tpu_torch.get(ref) for a, ref in probe_refs.items()}
        worker = get_global_worker()
        driver_node = worker.node_id.hex() if worker.node_id is not None else ""

        token = uuid.uuid4().hex[:12]
        self._token = token
        chan_meta: Dict[str, dict] = {}  # cid -> {writer: ep, reader: ep}
        counter = [0]

        def new_chan(writer_ep: str, reader_ep: str) -> str:
            counter[0] += 1
            cid = f"c{counter[0]}"
            chan_meta[cid] = {"writer": writer_ep, "reader": reader_ep}
            return cid

        ops_by_actor: Dict[str, list] = {}
        # (cid, key-or-None) the driver writes each execute.
        self._input_chans: List[tuple] = []
        # Input-independent source ops produce ONE frame per loop pass;
        # execute_many's batched frames would desync their edges, so
        # such graphs take the sequential fallback.
        self._has_const_sources = any(
            all(not isinstance(a, DAGNode) for a in (
                n._bound_args[1:] if isinstance(n, ClassMethodNode) else n._bound_args
            ))
            for n in method_nodes
        )

        for n in method_nodes:
            a_uuid = actor_of[n._stable_uuid]
            if isinstance(n, ClassMethodNode):
                op = {"uuid": n._stable_uuid, "method": n._method, "args": [], "outs": []}
                data_args = n._bound_args[1:]
            else:
                op = {
                    "uuid": n._stable_uuid,
                    "method": n._remote_fn._function.__name__,
                    "fn": 0,
                    "args": [],
                    "outs": [],
                }
                data_args = n._bound_args
            for arg in data_args:
                if isinstance(arg, InputNode):
                    cid = new_chan("driver", a_uuid)
                    self._input_chans.append((cid, None))
                    op["args"].append(("chan", cid))
                elif isinstance(arg, InputAttributeNode):
                    cid = new_chan("driver", a_uuid)
                    self._input_chans.append((cid, arg._key))
                    op["args"].append(("chan", cid))
                elif isinstance(arg, (ClassMethodNode, FunctionNode)):
                    src = arg._stable_uuid
                    if actor_of[src] == a_uuid:
                        op["args"].append(("local", src))
                    else:
                        cid = new_chan(actor_of[src], a_uuid)
                        for ops in ops_by_actor.values():
                            for prod_op in ops:
                                if prod_op["uuid"] == src:
                                    prod_op["outs"].append(cid)
                        op["args"].append(("chan", cid))
                else:
                    op["args"].append(("const", arg))
            ops_by_actor.setdefault(a_uuid, []).append(op)

        # Output channels to the driver, in MultiOutput order.
        self._output_chans = []
        for o in outputs:
            cid = new_chan(actor_of[o._stable_uuid], "driver")
            for ops in ops_by_actor.values():
                for op in ops:
                    if op["uuid"] == o._stable_uuid:
                        op["outs"].append(cid)
            self._output_chans.append(cid)

        # -- transport selection + descriptor table ---------------------
        def node_of(ep: str) -> str:
            return driver_node if ep == "driver" else node_of_actor[ep]

        ring_dir = _ring_dir(token)
        self._chan_dir = ring_dir
        descs: Dict[str, dict] = {}
        ring_reads: Dict[str, list] = {}
        socket_binds: Dict[str, list] = {}
        driver_ring_reads: List[str] = []
        driver_socket_reads: List[str] = []
        for cid, meta in chan_meta.items():
            if node_of(meta["writer"]) == node_of(meta["reader"]):
                descs[cid] = {"kind": "ring", "path": os.path.join(ring_dir, cid)}
                if meta["reader"] == "driver":
                    driver_ring_reads.append(cid)
                else:
                    ring_reads.setdefault(meta["reader"], []).append(cid)
            else:
                descs[cid] = {"kind": "socket", "token": token, "id": cid}
                if meta["reader"] == "driver":
                    driver_socket_reads.append(cid)
                else:
                    socket_binds.setdefault(meta["reader"], []).append(cid)
        self._chan_meta = chan_meta
        self._descs = descs

        # -- setup phase: every reader creates/binds its endpoints ------
        os.makedirs(ring_dir, exist_ok=True)
        # tmpfs survives the process: reclaim even when the user never
        # calls teardown (GC / interpreter exit).
        import shutil
        import weakref

        self._chan_finalizer = weakref.finalize(
            self, shutil.rmtree, ring_dir, ignore_errors=True
        )
        for cid in driver_ring_reads:
            channel_mod.Channel.create_file(descs[cid]["path"], self._buffer_size)
        ports: Dict[str, int] = {}
        for cid in driver_socket_reads:
            ports[cid] = channel_mod.bind_listener(token, cid)
        setup_refs = {
            a: actors[a].__ray_call__.remote(
                _dag_setup, token, ring_reads.get(a, []),
                socket_binds.get(a, []), self._buffer_size,
            )
            for a in live_actor_uuids
        }
        try:
            for a, ref in setup_refs.items():
                ports.update(ray_tpu_torch.get(ref))
            hosts = self._node_hosts(worker)
            for cid, desc in descs.items():
                if desc["kind"] == "socket":
                    reader_node = node_of(chan_meta[cid]["reader"])
                    desc["addr"] = (hosts.get(reader_node, "127.0.0.1"), ports[cid])

            # -- start the resident loops, then open driver endpoints ----
            self._loop_refs = []
            for a_uuid, ops in ops_by_actor.items():
                actor = actors[a_uuid]
                actor_cids = {
                    cid
                    for op in ops
                    for cid in [v for k, v in op["args"] if k == "chan"] + op["outs"]
                }
                self._loop_refs.append(
                    actor.__ray_call__.remote(
                        _actor_channel_loop, ops,
                        {cid: descs[cid] for cid in actor_cids}, token,
                    )
                )
            connect_t = CONFIG.dag_socket_connect_timeout_s
            self._driver_in = [
                (channel_mod.open_channel(descs[cid], "write", timeout=connect_t), key)
                for cid, key in self._input_chans
            ]
            self._driver_out = [
                channel_mod.open_channel(descs[cid], "read", timeout=connect_t)
                for cid in self._output_chans
            ]
            import collections

            # Per-output-channel pending per-execution entries: a batched
            # frame (execute_many) expands to K entries here.
            self._out_pending = [collections.deque() for _ in self._driver_out]
            # fail-closed flags: an output edge that delivered a
            # corrupted frame can never deliver a trustworthy SEQUENCE
            # again (see _pump_output); the graph-level flag also stops
            # new executions (they could never be associated with a
            # result) with the typed error instead of bleeding the
            # in-flight budget dry into an opaque cap error
            self._out_poisoned = [False for _ in self._driver_out]
            # "corruption" | "closed" once an output edge can never
            # deliver again: execute() refuses typed instead of writing
            # into a dead ring until the in-flight cap throws an opaque
            # RuntimeError
            self._fail_closed = None
        except Exception:
            channel_mod.drop_listeners(token)
            raise
        self._channels_on = True

    # -- execution ------------------------------------------------------
    @staticmethod
    def _extract(input_val, key):
        if key is None:
            return input_val
        if isinstance(key, str) and isinstance(input_val, dict):
            return input_val[key]
        if isinstance(key, int):
            return input_val[key]
        return getattr(input_val, key)

    def _raise_fail_closed(self):
        from ray_tpu_torch.experimental import channel as channel_mod

        if self._fail_closed == "corruption":
            raise channel_mod.ChannelCorruptionError(
                "compiled DAG is fail-closed after frame corruption; "
                "teardown and recompile"
            )
        raise channel_mod.ChannelClosed(
            "compiled DAG output edge is closed; teardown and recompile"
        )

    def execute(self, *input_vals):
        input_val = input_vals[0] if len(input_vals) == 1 else (input_vals if input_vals else None)
        if self._channels_on:
            from ray_tpu_torch.experimental import channel as channel_mod

            if self._fail_closed is not None:
                self._raise_fail_closed()

            def extract(key):
                return self._extract(input_val, key)

            with self._lock:
                if self._seq - self._next_result + 1 >= self._max_inflight:
                    raise RuntimeError(
                        f"{self._max_inflight} executions already in flight; "
                        f"ray_tpu_torch.get earlier results first (raise max_inflight "
                        f"at experimental_compile if the pipeline is deeper)"
                    )
                self._seq += 1
                # Fan-out scheduling: issue every input write (round-robin
                # on blocked edges) before blocking on any single one, so
                # independent branches start in parallel.
                channel_mod.write_value_fanout(
                    [(chan, extract(key), 0) for chan, key in self._driver_in],
                )
                from ray_tpu_torch._private import telemetry

                telemetry.count_dag_execution()
                self._inflight_contrib += 1
                _inflight_adjust(+1)
                return CompiledDAGRef(self, self._seq)
        cache: Dict[str, Any] = {}
        with self._lock:
            for node in self._order:
                cache[node._stable_uuid] = node._execute_one(cache, input_val, self._ctx)
        return cache[self._root._stable_uuid]

    def execute_many(self, input_vals) -> List["CompiledDAGRef"]:
        """Batch K executions into ONE channel write per input edge (and
        one result frame per output edge): high-rate small-payload
        traffic (trajectory fragments, weight broadcasts, router fan-in)
        amortizes the per-message wire overhead K-fold.  Returns one
        CompiledDAGRef per input, in order.

        Falls back to K sequential ``execute`` calls for graphs the
        batched schedule can't express: uncompiled graphs, and graphs
        with input-independent source nodes (their single frames would
        desync batched edges)."""
        input_vals = list(input_vals)
        k = len(input_vals)
        if k == 0:
            return []
        if k == 1 or not self._channels_on or self._has_const_sources:
            return [self.execute(v) for v in input_vals]
        from ray_tpu_torch._private import serialization, telemetry
        from ray_tpu_torch.experimental import channel as channel_mod

        if self._fail_closed is not None:
            self._raise_fail_closed()
        with self._lock:
            if self._seq - self._next_result + k >= self._max_inflight:
                raise RuntimeError(
                    f"{k} batched executions would exceed max_inflight="
                    f"{self._max_inflight}; ray_tpu_torch.get earlier results first "
                    f"(raise max_inflight at experimental_compile for deeper "
                    f"pipelines)"
                )
            channel_mod.write_value_fanout(
                [
                    (
                        chan,
                        [self._extract(v, key) for v in input_vals],
                        serialization.TAG_BATCH,
                    )
                    for chan, key in self._driver_in
                ],
            )
            telemetry.count_dag_execution(k)
            refs = []
            for _ in range(k):
                self._seq += 1
                refs.append(CompiledDAGRef(self, self._seq))
            self._inflight_contrib += k
            _inflight_adjust(+k)
        return refs

    def _pump_output(self, idx: int, timeout: Optional[float]) -> None:
        """Ensure output channel ``idx`` has at least one pending
        per-execution entry (expands batched frames to K entries).

        Dataplane faults surface typed, never as wrong data or a stuck
        driver: a corrupted result frame fail-closes the edge (its
        multiplicity is unknowable — see the inline comment), and a
        closed edge takes one shared reattach() attempt before
        propagating."""
        import collections

        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.experimental import channel as channel_mod

        if self._out_poisoned[idx]:
            self._raise_fail_closed()
        pending = self._out_pending[idx]
        while not pending:
            try:
                tag, value = self._driver_out[idx].read_value(timeout)
            except channel_mod.ChannelCorruptionError:
                # The corrupted frame may have been a TAG_BATCH of K
                # results: any guess at multiplicity would mis-associate
                # every later result with the wrong ref.  Fail closed —
                # this edge delivers nothing further, every pending and
                # future get() on it raises typed.
                self._out_poisoned[idx] = True
                self._fail_closed = "corruption"
                raise
            except channel_mod.ChannelClosed:
                if channel_mod.reattach(self._driver_out[idx]):
                    continue
                # the edge is dead for good: no submitted or future
                # execution can ever resolve on it
                self._fail_closed = "closed"
                raise
            if tag == serialization.TAG_BATCH:
                for item in value:
                    if isinstance(item, exceptions.RayTaskError):
                        pending.append((serialization.TAG_ERROR, item))
                    else:
                        pending.append((serialization.TAG_NORMAL, item))
            else:
                pending.append((tag, value))

    def _read_result(self, seq: int, timeout: Optional[float]):
        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private import serialization

        with self._lock:
            drained_from = self._next_result
            try:
                while self._next_result <= seq:
                    # _out_pending survives a ChannelTimeout partway
                    # through a multi-output read: already-consumed
                    # channels keep their entries queued, so results
                    # can't cross executions on retry.
                    for i in range(len(self._driver_out)):
                        self._pump_output(i, timeout)
                    vals = [self._out_pending[i].popleft() for i in range(len(self._driver_out))]
                    if any(tag == serialization.TAG_ERROR for tag, _ in vals):
                        out = next(v for tag, v in vals if tag == serialization.TAG_ERROR)
                    else:
                        out = (
                            [v for _, v in vals]
                            if isinstance(self._root, MultiOutputNode)
                            else vals[0][1]
                        )
                    self._results[self._next_result] = out
                    self._next_result += 1
                result = self._results.pop(seq)
            finally:
                # One decrement per execution DRAINED (in the finally so
                # a ChannelTimeout mid-loop still accounts the results
                # it did materialize), not per get() call: a get() on a
                # later ref materializes every earlier result too, and
                # decrementing once would leave the gauge elevated
                # forever.
                drained = self._next_result - drained_from
                if drained:
                    self._inflight_contrib = max(0, self._inflight_contrib - drained)
                    _inflight_adjust(-drained)
        if isinstance(result, exceptions.RayTaskError):
            raise result.as_instanceof_cause()
        return result

    def stats(self) -> Dict[str, Any]:
        """Driver-side dataplane counters: per-channel transport kind,
        op/blocked-time/timeout stats, and in-flight occupancy (the
        compiled-graphs bottleneck view; actor-side op timings flow
        through telemetry as ``dag_op_seconds``/``channel_*``).

        Never blocks: ``_read_result`` holds ``self._lock`` across its
        (possibly long) channel reads, and a diagnostic view that hangs
        exactly when the DAG is stalled would be useless.  If the lock
        is busy the snapshot is taken lockless (counters are plain
        ints/dicts — a torn read costs one off-by-one in a diagnostic,
        flagged via ``"consistent": False``)."""
        locked = self._lock.acquire(blocking=False)
        try:
            inflight = self._seq - self._next_result + 1
            out: Dict[str, Any] = {
                "compiled": self._channels_on,
                "consistent": locked,
                "executions": self._seq,
                "inflight": max(0, inflight),
                "max_inflight": self._max_inflight,
                "input_channels": [],
                "output_channels": [],
            }
            if self._channels_on:
                for chan, key in self._driver_in:
                    out["input_channels"].append(
                        {"key": key, "kind": chan.kind, "pending": chan.pending(), **chan.stats}
                    )
                for chan in self._driver_out:
                    out["output_channels"].append(
                        {"kind": chan.kind, "pending": chan.pending(), **chan.stats}
                    )
        finally:
            if locked:
                self._lock.release()
        return out

    def teardown(self):
        import shutil

        import ray_tpu_torch

        # Return this DAG's undrained executions to the process gauge:
        # a torn-down (or abandoned) DAG must not pin dag_inflight.
        with self._lock:
            leftover, self._inflight_contrib = self._inflight_contrib, 0
        if leftover:
            _inflight_adjust(-leftover)
        if self._channels_on:
            for chan, _ in self._driver_in:
                try:
                    chan.close()
                except Exception:
                    pass
            for chan in self._driver_out:
                try:
                    chan.close()
                except Exception:
                    pass
            self._channels_on = False
            # The local ring files live in tmpfs: they must be unlinked
            # or the RAM survives this process (each actor loop reclaims
            # its own node's directory on exit).
            shutil.rmtree(getattr(self, "_chan_dir", ""), ignore_errors=True)
        for actor in self._ctx.get("actors", {}).values():
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        self._ctx["actors"] = {}


class _NotChannelable(Exception):
    pass


def bind_function(remote_fn):
    def bind(*args, **kwargs) -> FunctionNode:
        return FunctionNode(remote_fn, args, kwargs)

    return bind


def bind_actor_class(actor_cls):
    def bind(*args, **kwargs) -> ClassNode:
        return ClassNode(actor_cls, args, kwargs)

    return bind
