"""CLI: `python -m ray_tpu_torch.scripts.cli <cmd>` or the `ray-tpu-torch` console
script (reference: python/ray/scripts/scripts.py — ray
start/stop/status/submit/memory/timeline/profile/list)."""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def cmd_start(args):
    from ray_tpu_torch._private import node as node_mod

    if args.head:
        procs = node_mod.start_head(
            num_cpus=args.num_cpus, num_gpus=args.num_gpus,
            resources=json.loads(args.resources) if args.resources else None,
            # detached unless --block: survive this CLI process
            owner_pid=os.getpid() if args.block else 0,
        )
        print(f"started head: gcs={procs.gcs_address}")
        print(f"session dir: {procs.session_dir}")
        print("connect with ray_tpu_torch.init(address='auto') or "
              f"ray_tpu_torch.init(address='{procs.gcs_address}')")
        if args.block:
            try:
                while all(p.poll() is None for p in procs.procs):
                    time.sleep(1)
            except KeyboardInterrupt:
                procs.terminate()
        return 0
    else:
        address = args.address or _auto_address()
        if not address:
            print("error: --address required (or start a head first)", file=sys.stderr)
            return 1
        from ray_tpu_torch._private.node import new_session_dir, start_worker_node

        session_dir = _session_dir_of(address) or new_session_dir()
        proc, raylet_addr = start_worker_node(
            address, session_dir,
            num_cpus=args.num_cpus, num_gpus=args.num_gpus,
            resources=json.loads(args.resources) if args.resources else None,
            owner_pid=os.getpid() if args.block else 0,
        )
        print(f"started worker node: raylet={raylet_addr}")
        if args.block:
            try:
                proc.wait()
            except KeyboardInterrupt:
                proc.terminate()
        return 0


def cmd_stop(args):
    """Terminate all ray_tpu_torch processes of the current user (reference:
    `ray stop`).  The pattern names the port's own entry points only, so a
    JAX package's ``ray_tpu._private.*`` process is never matched."""
    out = subprocess.run(
        ["pkill", "-f", r"ray_tpu_torch\._private\.(head_main|raylet_main|default_worker)"],
        capture_output=True,
    )
    from ray_tpu_torch._private.node import CLUSTER_ADDRESS_FILE

    try:
        os.unlink(CLUSTER_ADDRESS_FILE)
    except OSError:
        pass
    print("stopped" if out.returncode in (0, 1) else "pkill failed")
    return 0


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=args.address or "auto")
    return ray_tpu_torch


def cmd_status(args):
    ray_tpu_torch = _connect(args)
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    nodes = ray_tpu_torch.nodes()
    print(f"nodes: {sum(1 for n in nodes if n['Alive'])} alive / {len(nodes)} total")
    for n in nodes:
        mark = "*" if n["IsHead"] else " "
        print(f" {mark} {n['NodeID'][:12]} alive={n['Alive']} {n['Resources']}")
    print("resources:")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0.0):g}/{total[k]:g} available")
    return 0


def cmd_list(args):
    from ray_tpu_torch.util import state

    _connect(args)
    kind = args.kind
    fn = {
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "workers": state.list_workers,
        "placement-groups": state.list_placement_groups,
        "jobs": state.list_jobs,
    }[kind]
    rows = fn()
    print(json.dumps(rows, indent=1, default=str))
    return 0


def cmd_summary(args):
    from ray_tpu_torch.util import state

    _connect(args)
    if args.kind == "cluster":
        tasks = state.summarize_tasks()
        traces = state.traces()
        recs = state.metrics()
        print(json.dumps(
            {
                "nodes_alive": tasks["node_count"],
                "tasks": tasks["summary"],
                "actors": state.summarize_actors()["summary"],
                "metric_series": len(recs),
                "traces": len(traces),
                "cross_process_traces": sum(1 for t in traces if len(t["pids"]) >= 2),
            },
            indent=1, default=str,
        ))
        return 0
    fn = {"tasks": state.summarize_tasks, "actors": state.summarize_actors}[args.kind]
    print(json.dumps(fn(), indent=1, default=str))
    return 0


def cmd_timeline(args):
    from ray_tpu_torch.util import state

    _connect(args)
    path = args.output or f"ray_tpu_torch_timeline_{int(time.time())}.json"
    state.timeline(path, include_spans=not args.tasks_only)
    print(f"wrote chrome trace to {path} (open in chrome://tracing or perfetto)")
    return 0


def cmd_profile(args):
    """Attach the on-demand sampling profiler to a live target and write
    the merged capture (docs/profiling.md)."""
    from ray_tpu_torch.util import state

    _connect(args)
    result = state.profile(
        args.target or None,
        duration_s=args.duration,
        hz=args.hz,
        mode=args.mode,
    )
    fmt = args.format
    path = args.output or f"ray_tpu_torch_profile_{int(time.time())}." + (
        "speedscope.json" if fmt == "speedscope" else "folded"
    )
    result.save(path, fmt=fmt)
    summary = result.summary()
    for err in summary["errors"]:
        print(f"warning: {err}")
    print(
        f"wrote {fmt} profile to {path} "
        f"({summary['total_samples']} samples from {len(summary['targets'])} process(es))"
    )
    for row in summary["top_frames"][:5]:
        print(f"  {row['fraction']:>6.1%}  {row['frame']}")
    return 0


def cmd_memory(args):
    from ray_tpu_torch.util import state

    _connect(args)
    objs = state.list_objects()
    total = sum(o.get("size", 0) for o in objs)
    print(f"{len(objs)} objects, {total / 1e6:.1f} MB total")
    for o in objs[: args.limit]:
        print(f"  {o.get('object_id', '?')[:16]} {o.get('size', 0):>10} B node={o.get('node_id', '?')[:8]}")
    return 0


def cmd_submit(args):
    """Run a script against a cluster (reference: `ray job submit` /
    dashboard/modules/job — here: direct subprocess with the cluster
    address injected)."""
    address = args.address or _auto_address()
    if not address:
        print("error: no running cluster found", file=sys.stderr)
        return 1
    env = dict(os.environ)
    env["RAY_TPU_TORCH_ADDRESS"] = address
    cmd = [sys.executable, args.script] + args.script_args
    print(f"submitting {' '.join(cmd)} to {address}")
    return subprocess.call(cmd, env=env)


def cmd_serve_deploy(args):
    """Apply a declarative Serve config (reference: serve/scripts.py
    deploy)."""
    from ray_tpu_torch.serve.schema import ServeDeploySchema
    from ray_tpu_torch.serve.api import deploy_config

    _connect(args)
    schema = ServeDeploySchema.from_file(args.config_file)
    statuses = deploy_config(schema)
    for app, deps in statuses.items():
        print(f"application {app!r}:")
        for name in deps:
            print(f"  deployed {name}")
    return 0


def cmd_serve_status(args):
    from ray_tpu_torch import serve

    _connect(args)
    print(json.dumps(serve.status(), indent=1, default=str))
    return 0


def cmd_serve_build(args):
    """Emit a deploy config for an importable app (reference:
    serve/scripts.py build)."""
    from ray_tpu_torch.serve.schema import ServeDeploySchema, build_app_schema

    schema = ServeDeploySchema(
        applications=[
            build_app_schema(path, name=f"app{i}" if i else "default")
            for i, path in enumerate(args.import_paths)
        ]
    )
    if args.output:
        schema.to_yaml(args.output)
        print(f"wrote {args.output}")
    else:
        import yaml

        print(yaml.safe_dump(schema.to_dict(), sort_keys=False))
    return 0


def cmd_serve_run(args):
    """Deploy one importable app and block (reference: serve run)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.schema import import_attr

    _connect(args)
    app = import_attr(args.import_path)
    serve.run(app, http_port=args.port)
    print(f"serving {args.import_path} on port {args.port}; ctrl-c to exit")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        serve.shutdown()
    return 0


def cmd_serve_shutdown(args):
    from ray_tpu_torch import serve

    _connect(args)
    serve.shutdown()
    print("serve shut down")
    return 0


def _auto_address():
    from ray_tpu_torch._private.node import CLUSTER_ADDRESS_FILE

    try:
        with open(CLUSTER_ADDRESS_FILE) as f:
            return f.read().strip()
    except OSError:
        return None


def _session_dir_of(address: str):
    # unix:/tmp/ray_tpu_torch/session_x/sockets/gcs.sock -> /tmp/ray_tpu_torch/session_x
    if address.startswith("unix:"):
        p = address[len("unix:"):]
        d = os.path.dirname(os.path.dirname(p))
        if os.path.isdir(d):
            return d
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray-tpu-torch", description="ray_tpu_torch cluster CLI")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="GCS address to join (worker nodes)")
    p.add_argument("--num-cpus", type=int, default=None)
    p.add_argument("--num-gpus", type=int, default=None)
    p.add_argument("--resources", help="JSON dict of custom resources")
    p.add_argument("--block", action="store_true", help="stay attached")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop all local ray_tpu_torch processes")
    p.set_defaults(fn=cmd_stop)

    for name, fn in (("status", cmd_status),):
        p = sub.add_parser(name)
        p.add_argument("--address", default=None)
        p.set_defaults(fn=fn)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", choices=["actors", "nodes", "tasks", "objects", "workers", "placement-groups", "jobs"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary", help="summarize tasks/actors/cluster observability")
    p.add_argument("kind", choices=["tasks", "actors", "cluster"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser(
        "timeline",
        help="export cluster flight-recorder trace (task events + cross-process spans)",
    )
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--tasks-only", action="store_true",
                   help="omit spans; task events only (pre-flight-recorder shape)")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "profile",
        help="attach the sampling profiler to a live actor/node/gcs/cluster",
    )
    p.add_argument("target", nargs="?", default=None,
                   help="actor id hex, node id hex, 'gcs', or omit for the whole cluster")
    p.add_argument("-d", "--duration", type=float, default=5.0)
    p.add_argument("--hz", type=float, default=None)
    p.add_argument("--mode", choices=("wall", "cpu"), default="wall")
    p.add_argument("-f", "--format", choices=("collapsed", "speedscope"),
                   default="collapsed")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("memory", help="object store usage")
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("submit", help="run a script with the cluster address injected")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_submit)

    # serve config plane (reference: serve/scripts.py — serve
    # build/deploy/status/run/shutdown)
    ps = sub.add_parser("serve", help="model-serving config plane")
    ssub = ps.add_subparsers(dest="serve_cmd", required=True)

    p = ssub.add_parser("deploy", help="apply a YAML/JSON serve config")
    p.add_argument("config_file")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_deploy)

    p = ssub.add_parser("status", help="deployment statuses")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_status)

    p = ssub.add_parser("build", help="emit a deploy config from importable apps")
    p.add_argument("import_paths", nargs="+", help="module:attr of Application(s)")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_serve_build)

    p = ssub.add_parser("run", help="deploy one app and block")
    p.add_argument("import_path")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_run)

    p = ssub.add_parser("shutdown", help="tear down all serve apps")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_shutdown)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
