"""verdi-style command line interface over the provenance store.

    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> process list
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> process report <pk>
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> process show <pk>
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> node show <pk>
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> graph export <pk> --out g.dot
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> stats
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> cache stats
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> cache show <pk>
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> cache invalidate --process-type Foo
    PYTHONPATH=src python -m repro_torch.cli -p <profile.db> cache backfill [--dry-run]

Provenance archives (cross-profile export/import, docs/archive.md):

    python -m repro_torch.cli -p <profile.db> archive create -o results.zip --pk 42 [--all]
    python -m repro_torch.cli -p <profile.db> archive inspect results.zip
    python -m repro_torch.cli -p <other.db>   archive import results.zip

Control-plane verbs (the event-driven engine surface):

    python -m repro_torch.cli -p <profile.db> process pause|play|kill|status <pk> [-w WORKDIR]
    python -m repro_torch.cli -p <profile.db> process watch [--pk PK] [--once] [--timeout T]
    python -m repro_torch.cli -p <profile.db> process top [--once] [--interval S]

Chaos engineering (docs/chaos.md):

    python -m repro_torch.cli chaos list
    python -m repro_torch.cli chaos points
    python -m repro_torch.cli chaos run --scenario kill9-midstep --seed 1 [--json]
    python -m repro_torch.cli -p <profile.db> chaos check [--pk PK --expect-terminal]

Observability (docs/observability.md): `stats --json` merges the node
counts with the metrics snapshots advertised by every daemon worker;
`process top` is the live worker/process table; `process report <pk>`
renders per-state dwell times and, for runs traced with REPRO_TRACE=1,
the persisted span timeline.

Mirrors the AiiDA `verdi process ...` verbs the paper's users drive the
engine with. Control verbs go through the broker's RPC channel to whichever
daemon worker owns the process; `watch` tails the state_changed.<pk>.<state>
broadcast stream live. WORKDIR is the daemon working directory holding
broker.json (default: the directory of the profile db).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.provenance.store import (
    LinkType, NodeType, ProvenanceStore, QueryBuilder,
)


def _fmt_age(ts: float) -> str:
    d = time.time() - ts
    if d < 120:
        return f"{d:.0f}s"
    if d < 7200:
        return f"{d/60:.0f}m"
    return f"{d/3600:.1f}h"


def cmd_process_list(store: ProvenanceStore, args) -> None:
    qb = (QueryBuilder(store).nodes("process").order_by("pk", desc=True)
          .project("pk", "ctime", "process_type", "process_state",
                   "exit_status", "label"))
    if args.state:
        qb = qb.with_state(args.state)
    rows = qb.limit(args.limit).all()
    print(f"{'PK':>6}  {'age':>6}  {'type':28}  {'state':10}  "
          f"{'exit':>4}  label")
    for r in rows:
        print(f"{r['pk']:>6}  {_fmt_age(r['ctime']):>6}  "
              f"{(r['process_type'] or '')[:28]:28}  "
              f"{(r['process_state'] or ''):10}  "
              f"{r['exit_status'] if r['exit_status'] is not None else '':>4}"
              f"  {r['label'] or ''}")
    total = QueryBuilder(store).nodes("process").count()
    print(f"\n{len(rows)} shown of {total} processes")


def cmd_process_report(store: ProvenanceStore, args) -> None:
    from repro_torch.observability.timeline import (
        TRACE_LEVELNAME, load_spans, render_dwell, render_timeline,
    )

    node = store.get_node(args.pk)
    if node is None:
        sys.exit(f"no node with pk={args.pk}")
    print(f"{node['process_type']}<{args.pk}> "
          f"[{node['process_state']}] exit={node['exit_status']}")
    for log in store.get_logs(args.pk):
        if log["levelname"] == TRACE_LEVELNAME:
            continue  # span timelines get their own rendering below
        stamp = time.strftime("%H:%M:%S", time.localtime(log["time"]))
        print(f"  {stamp} [{log['levelname']}] {log['message']}")
    # recurse into called subprocesses
    for child_pk, lt, label in store.outgoing(args.pk):
        if lt.startswith("call"):
            child = store.get_node(child_pk)
            print(f"  +-- {child['process_type']}<{child_pk}> "
                  f"[{child['process_state']}] exit={child['exit_status']}")
    print("\nstate dwell times:")
    print(render_dwell(node))
    print("\nspan timeline:")
    print(render_timeline(load_spans(store, args.pk)))


def cmd_process_show(store: ProvenanceStore, args) -> None:
    node = store.get_node(args.pk)
    if node is None:
        sys.exit(f"no node with pk={args.pk}")
    print(json.dumps({k: v for k, v in node.items()
                      if k not in ("checkpoint", "payload")},
                     indent=2, default=str))
    print("inputs:")
    for pk, lt, label in store.incoming(args.pk):
        print(f"  {label:30} <- {lt:12} node {pk}")
    print("outputs:")
    for pk, lt, label in store.outgoing(args.pk):
        print(f"  {label:30} -> {lt:12} node {pk}")


def cmd_node_show(store: ProvenanceStore, args) -> None:
    node = store.get_node(args.pk)
    if node is None:
        sys.exit(f"no node with pk={args.pk}")
    if node["node_type"] == NodeType.DATA.value:
        value = store.load_data(args.pk)
        print(f"DataNode<{args.pk}> uuid={node['uuid']}")
        print(f"  value: {value!r}")
    else:
        cmd_process_show(store, args)


def cmd_graph_export(store: ProvenanceStore, args) -> None:
    """Export the provenance neighbourhood of a node as graphviz dot."""
    seen: set[int] = set()
    edges: list[tuple[int, int, str, str]] = []
    frontier = [args.pk]
    for _ in range(args.depth):
        nxt = []
        for pk in frontier:
            if pk in seen:
                continue
            seen.add(pk)
            for src, lt, label in store.incoming(pk):
                edges.append((src, pk, lt, label))
                nxt.append(src)
            for dst, lt, label in store.outgoing(pk):
                edges.append((pk, dst, lt, label))
                nxt.append(dst)
        frontier = nxt
    seen.update(pk for e in edges for pk in e[:2])

    lines = ["digraph provenance {", "  rankdir=LR;"]
    for pk in sorted(seen):
        n = store.get_node(pk)
        if n is None:
            continue
        if n["node_type"] == NodeType.DATA.value:
            shape, color = "ellipse", "lightgoldenrod"
            label = f"{pk}"
        else:
            shape = "box"
            color = {"finished": "lightgreen", "excepted": "salmon",
                     "killed": "salmon"}.get(n["process_state"], "lightblue")
            label = f"{n['process_type']}\\n({pk}) {n['process_state']}"
        lines.append(f'  n{pk} [label="{label}", shape={shape}, '
                     f'style=filled, fillcolor={color}];')
    for src, dst, lt, label in sorted(set(edges)):
        style = "dashed" if lt.startswith("call") else "solid"
        lines.append(f'  n{src} -> n{dst} [label="{label}", style={style}];')
    lines.append("}")
    out = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(out)
        print(f"wrote {args.out} ({len(seen)} nodes, {len(set(edges))} edges)")
    else:
        print(out)


def _resolve_process_class(path: str) -> type:
    """Import a process class from 'pkg.module:Class', 'pkg.module.Class'
    or a bare name exported by repro_torch.core / repro_torch.calcjobs.
    A class of the reference package is refused without importing it:
    that would load JAX, and this package runs only its own classes."""
    import importlib

    from repro_torch.core.process import (
        Process, ReferencePackageError, refuse_reference,
    )

    candidates = []
    if ":" in path:
        candidates.append(tuple(path.split(":", 1)))
    elif "." in path:
        mod, _, qual = path.rpartition(".")
        candidates.append((mod, qual))
    else:
        candidates.extend((("repro_torch.core", path),
                           ("repro_torch.calcjobs", path)))
    for mod_name, _ in candidates:
        try:
            refuse_reference(mod_name, f"process class {path!r}")
        except ReferencePackageError as exc:
            sys.exit(f"cannot resolve process class: {exc}")
    errors = []
    for mod_name, qual in candidates:
        try:
            obj = importlib.import_module(mod_name)
            for part in qual.split("."):
                obj = getattr(obj, part)
        except (ImportError, AttributeError) as exc:
            errors.append(str(exc))
            continue
        if isinstance(obj, type) and issubclass(obj, Process):
            return obj
        # process functions carry their Process class on the wrapper
        proc_cls = getattr(obj, "process_class", None)
        if isinstance(proc_cls, type) and issubclass(proc_cls, Process):
            return proc_cls
        errors.append(f"{path} is not a Process subclass")
    sys.exit(f"cannot resolve process class {path!r}: " + "; ".join(errors))


def _print_port_tree(ns, indent: int = 2) -> None:
    from repro_torch.core.ports import PortNamespace

    pad = " " * indent
    for name, port in sorted(ns.items()):
        if isinstance(port, PortNamespace):
            flags = [f for f, on in (("dynamic", port.dynamic),
                                     ("non_db", port.non_db)) if on]
            suffix = f" ({', '.join(flags)})" if flags else ""
            print(f"{pad}{name}/ namespace{suffix}")
            _print_port_tree(port, indent + 2)
            continue
        types = ("|".join(t.__name__ for t in port.valid_type)
                 if port.valid_type else "any")
        bits = ["required" if port.required else "optional"]
        if port.has_default:
            try:
                bits.append(f"default={port.default!r}")
            except Exception:  # noqa: BLE001 — a broken default is still info
                bits.append("default=<callable>")
        if port.serializer is not None:
            bits.append(
                f"serializer={getattr(port.serializer, '__name__', '?')}")
        if port.non_db:
            bits.append("non_db")
        help_text = f"  — {port.help}" if port.help else ""
        print(f"{pad}{name:24} {types:16} {', '.join(bits)}{help_text}")


def cmd_process_inputs(store: ProvenanceStore, args) -> None:
    """Dump a process class's declared input/output spec (the discoverable
    launch surface behind Process.get_builder())."""
    cls = _resolve_process_class(args.process_class)
    spec = cls.spec()
    print(f"{cls.__name__} ({cls.__module__}:{cls.__qualname__})")
    print("inputs:")
    _print_port_tree(spec.inputs)
    print("outputs:")
    _print_port_tree(spec.outputs)
    if len(spec.exit_codes):
        print("exit codes:")
        for label, ec in sorted(spec.exit_codes.items(),
                                key=lambda kv: kv[1].status):
            print(f"  {ec.status:>5}  {label}: {ec.message}")


def _controller(args):
    from repro_torch.engine.controller import NoRunningDaemon, ProcessController

    workdir = args.workdir or os.path.dirname(os.path.abspath(args.profile))
    try:
        return ProcessController.from_workdir(workdir)
    except NoRunningDaemon as exc:
        sys.exit(str(exc))


def cmd_process_control(store: ProvenanceStore, args) -> None:
    """pause / play / kill / status through the broker RPC channel."""
    ctl = _controller(args)
    try:
        if args.sub == "status":
            print(json.dumps(ctl.status(args.pk), indent=2))
        elif args.sub == "kill":
            message = args.message or "killed by user"
            try:
                ctl.kill(args.pk, message)
                print(f"kill delivered to process {args.pk}")
            except (KeyError, TimeoutError):
                # not live on any worker (still queued, worker down, or
                # worker unresponsive): record the kill durably — the
                # process honours it at its next step boundary or pickup
                from repro_torch.engine.runner import TERMINAL
                node = store.get_node(args.pk)
                if node is None:
                    sys.exit(f"no node with pk={args.pk}")
                if node.get("process_state") in TERMINAL:
                    sys.exit(f"process {args.pk} is already terminal "
                             f"({node['process_state']})")
                store.update_process(args.pk,
                                     attributes={"kill_requested": message})
                # a worker may have picked the process up (and read the
                # marker) between our first attempt and the write above —
                # retry once now that the marker is down
                try:
                    ctl.kill(args.pk, message)
                    print(f"kill delivered to process {args.pk}")
                except (KeyError, TimeoutError):
                    print(f"process {args.pk} not live; kill recorded "
                          "durably (applies at its next step boundary or "
                          "worker pickup)")
        elif args.sub == "pause":
            ctl.pause(args.pk)
            print(f"pause delivered to process {args.pk}")
        elif args.sub == "play":
            ctl.play(args.pk)
            print(f"play delivered to process {args.pk}")
    except KeyError as exc:
        sys.exit(f"process {args.pk} has no live control endpoint: {exc}")
    except TimeoutError as exc:
        sys.exit(str(exc))
    finally:
        ctl.close()


def cmd_process_watch(store: ProvenanceStore, args) -> None:
    """Tail state-change events live from the broker's event stream."""
    from repro_torch.engine.controller import NoRunningDaemon, ProcessController

    workdir = args.workdir or os.path.dirname(os.path.abspath(args.profile))
    try:
        ctl = ProcessController.from_workdir(workdir)
    except NoRunningDaemon as exc:
        # `watch --once/--timeout` is used as a liveness probe (CI smoke):
        # a missing daemon is an answer, not an error
        if args.once or args.timeout is not None:
            print(f"{exc} — no events to watch")
            return
        sys.exit(str(exc))
    try:
        seen = 0
        for subject, sender, body in ctl.watch(
                pk=args.pk, timeout=args.timeout,
                replay_since=0 if args.replay else None):
            stamp = time.strftime("%H:%M:%S",
                                  time.localtime(body.get("ts", time.time())))
            exit_status = body.get("exit_status")
            suffix = "" if exit_status is None else f" (exit {exit_status})"
            print(f"{stamp}  pk={sender}  "
                  f"{body.get('from', '?')} -> {body.get('state', '?')}"
                  f"{suffix}", flush=True)
            seen += 1
            if args.once:
                return
        if not seen:
            print("no events within timeout")
    except KeyboardInterrupt:
        pass
    finally:
        ctl.close()


def _worker_snapshots(args) -> list[dict]:
    """Status dicts of the connected daemon workers ([] when no daemon
    is reachable — stats/top degrade to the local view then)."""
    from repro_torch.engine.controller import NoRunningDaemon, ProcessController

    workdir = (getattr(args, "workdir", None)
               or os.path.dirname(os.path.abspath(args.profile)))
    try:
        ctl = ProcessController.from_workdir(workdir, timeout=5.0)
    except NoRunningDaemon:
        return []
    try:
        return ctl.workers()
    except (ConnectionError, TimeoutError):
        return []
    finally:
        ctl.close()


def cmd_stats(store: ProvenanceStore, args) -> None:
    from repro_torch.observability.metrics import get_registry, merge_snapshots

    workers = _worker_snapshots(args)
    # this CLI process's own instruments (store stats from the profile
    # open above) merged with every worker's advertised snapshot
    merged = merge_snapshots(
        [get_registry().snapshot()]
        + [w.get("metrics") or {} for w in workers])
    node_counts = {}
    for nt in NodeType:
        c = QueryBuilder(store).nodes(nt).count() if nt != NodeType.DATA \
            else store.count_nodes(NodeType.DATA)
        if c:
            node_counts[nt.value] = c
    unfinished = store.unfinished_processes()

    if getattr(args, "json", False):
        print(json.dumps({
            "nodes": node_counts,
            "unfinished": len(unfinished),
            "metrics": merged,
            "repository": store.repository.stats(),
            "workers": [{k: v for k, v in w.items() if k != "metrics"}
                        for w in workers],
        }, indent=2))
        return

    print("node counts:")
    for name, c in node_counts.items():
        print(f"  {name:24} {c}")
    unfin = unfinished
    print(f"unfinished processes: {len(unfin)}")
    for n in unfin[:10]:
        print(f"  pk={n['pk']} {n['process_type']} [{n['process_state']}]")
    repo = store.repository.stats()
    print(f"repository: {repo['blobs']} blob(s), {repo['bytes']} byte(s)")
    if workers:
        print(f"daemon workers: {len(workers)}")
        for w in workers:
            print(f"  {w.get('worker', '?'):28} slots={w.get('slots', '?')}"
                  f" running={len(w.get('pks') or [])}")
    if merged["counters"]:
        print("counters:")
        for name, v in merged["counters"].items():
            print(f"  {name:32} {v}")
    for name, h in merged["histograms"].items():
        if h.get("count"):
            mean = h["sum"] / h["count"]
            print(f"  {name:32} n={h['count']} mean={mean * 1e3:.2f}ms")


def cmd_process_top(store: ProvenanceStore, args) -> None:
    """Live table of workers + the processes they are driving — the
    `verdi process list --live` answer, fed by worker advertisements."""
    from repro_torch.engine.controller import NoRunningDaemon, ProcessController
    from repro_torch.provenance.store import SUMMARY_COLUMNS

    workdir = (getattr(args, "workdir", None)
               or os.path.dirname(os.path.abspath(args.profile)))

    def render_once(ctl) -> None:
        workers = ctl.workers()
        print(time.strftime("%H:%M:%S"), f"— {len(workers)} worker(s)")
        print(f"{'worker':28}  {'pid':>7}  {'slots':>5}  {'run':>4}  "
              f"{'tasks':>6}  {'commits':>8}  {'rpc mean':>9}")
        for w in workers:
            snap = w.get("metrics") or {}
            counters = snap.get("counters") or {}
            rpc = (snap.get("histograms") or {}).get("broker.rpc_seconds")
            rpc_mean = (f"{rpc['sum'] / rpc['count'] * 1e3:.1f}ms"
                        if rpc and rpc.get("count") else "-")
            print(f"{w.get('worker', '?'):28}  {w.get('pid', ''):>7}  "
                  f"{w.get('slots', ''):>5}  {len(w.get('pks') or []):>4}  "
                  f"{counters.get('daemon.tasks', 0):>6}  "
                  f"{counters.get('store.commits', 0):>8}  {rpc_mean:>9}")
        pks = sorted({pk for w in workers for pk in (w.get("pks") or [])})
        if pks:
            rows = store.get_nodes(pks, columns=SUMMARY_COLUMNS)
            print(f"\n{'PK':>6}  {'age':>6}  {'type':28}  state")
            for pk in pks:
                node = rows.get(pk)
                if node is None:
                    continue
                print(f"{node['pk']:>6}  {_fmt_age(node['ctime']):>6}  "
                      f"{(node['process_type'] or '')[:28]:28}  "
                      f"{node['process_state'] or ''}")
        else:
            print("\nno live processes")

    try:
        ctl = ProcessController.from_workdir(workdir, timeout=5.0)
    except NoRunningDaemon as exc:
        # like `watch --once`: a missing daemon is an answer, not an error
        if args.once:
            print(f"{exc} — nothing running")
            return
        sys.exit(str(exc))
    try:
        while True:
            render_once(ctl)
            if args.once:
                return
            time.sleep(args.interval)
            print()
    except KeyboardInterrupt:
        pass
    finally:
        ctl.close()


def cmd_cache_stats(store: ProvenanceStore, args) -> None:
    from repro_torch.caching.registry import CacheRegistry

    stats = CacheRegistry(store).stats()
    print(f"{'process type':28}  {'hashed':>7}  {'distinct':>8}  "
          f"{'cache hits':>10}  {'collisions':>10}")
    for ptype, row in stats["process_types"].items():
        print(f"{ptype[:28]:28}  {row['hashed_nodes']:>7}  "
              f"{row['distinct_hashes']:>8}  {row['cache_hits']:>10}  "
              f"{row['hash_collisions']:>10}")
    print(f"\n{stats['hashed_nodes']} hashed process nodes, "
          f"{stats['cache_hits']} cache hits, "
          f"{stats['hash_collisions']} hash-collision occurrence(s)")
    if stats["hash_collisions"]:
        print("WARNING: same-fingerprint nodes produced different outputs;"
              " check CACHE_VERSION / exclude_from_hash declarations")


def cmd_cache_show(store: ProvenanceStore, args) -> None:
    from repro_torch.caching.registry import CacheRegistry

    node = store.get_node(args.pk)
    if node is None:
        sys.exit(f"no node with pk={args.pk}")
    if not node["node_type"].startswith("process"):
        sys.exit(f"node {args.pk} is a {node['node_type']} node; only "
                 "process nodes carry cache fingerprints")
    attrs = json.loads(node.get("attributes") or "{}")
    print(f"{node['process_type']}<{args.pk}> "
          f"[{node['process_state']}] exit={node['exit_status']}")
    print(f"  node_hash:   {node.get('node_hash') or '(invalidated/none)'}")
    if "cached_from" in attrs:
        print(f"  cached_from: {attrs['cached_from']} "
              f"(pk={attrs.get('cached_from_pk')})")
    else:
        print("  cached_from: — (computed, not cloned)")
    eq = CacheRegistry(store).equivalents(args.pk)
    print(f"  equivalents: {eq if eq else 'none'}")


def cmd_cache_backfill(store: ProvenanceStore, args) -> None:
    """Re-hash legacy (pre-caching) nodes so they serve cache hits."""
    from repro_torch.caching.backfill import backfill_hashes
    from repro_torch.core.process import ReferencePackageError

    try:
        stats = backfill_hashes(
            store,
            resolve_modules=args.resolve,
            process_types=args.process_type or None,
            batch_size=args.batch_size,
            dry_run=args.dry_run,
            include_invalidated=args.include_invalidated,
            progress=print)
    except ReferencePackageError as exc:
        sys.exit(f"cannot backfill: {exc}")
    verb = "would hash" if stats.dry_run else "hashed"
    print(f"{verb} {stats.hashed} of {stats.scanned} legacy node(s)")
    for ptype, n in sorted(stats.by_type.items()):
        print(f"  {ptype:28} {n}")
    if stats.skipped_unresolvable:
        print(f"  {stats.skipped_unresolvable} skipped: process class not "
              "importable (pass --resolve <module> for classes defined "
              "outside repro_torch.core/repro_torch.calcjobs)")
    if stats.skipped_invalidated:
        print(f"  {stats.skipped_invalidated} skipped: fingerprint was "
              "deliberately invalidated (--include-invalidated to re-hash)")
    if stats.skipped_error:
        print(f"  {stats.skipped_error} skipped: input reconstruction or "
              "hashing failed")
    if stats.collisions:
        print(f"WARNING: {stats.collisions} backfilled node(s) join an "
              "equivalence class with differing outputs (hash collision)")


def cmd_archive_create(store: ProvenanceStore, args) -> None:
    from repro_torch.provenance.archive import export_archive

    pks = args.pk or None
    if not args.all and not pks:
        sys.exit("give node selections with --pk (repeatable), or --all")
    manifest = export_archive(
        store, args.output, pks,
        ancestors=not args.no_ancestors,
        descendants=not args.no_descendants,
        source=os.path.abspath(args.profile))
    print(f"wrote {args.output}: {manifest['nodes']} node(s), "
          f"{manifest['links']} link(s), {manifest['logs']} log(s), "
          f"{manifest['payload_files']} array payload(s)")
    print(f"content digest {manifest['content_digest']}")


def cmd_archive_inspect(store: ProvenanceStore, args) -> None:
    from repro_torch.provenance.archive import ArchiveError, read_manifest

    try:
        manifest = read_manifest(args.archive)
    except ArchiveError as exc:
        sys.exit(str(exc))
    print(f"{args.archive} (archive version "
          f"{manifest['archive_version']})")
    if manifest.get("source"):
        print(f"  source:  {manifest['source']}")
    print(f"  nodes:   {manifest['nodes']}")
    for ntype, n in manifest.get("node_types", {}).items():
        print(f"    {ntype:24} {n}")
    print(f"  links:   {manifest['links']}")
    print(f"  logs:    {manifest['logs']}")
    print(f"  arrays:  {manifest['payload_files']}")
    print(f"  digest:  {manifest['content_digest']}")


def cmd_archive_import(store: ProvenanceStore, args) -> None:
    from repro_torch.provenance.archive import ArchiveError, import_archive

    try:
        result = import_archive(store, args.archive,
                                dedup=not args.no_dedup, progress=print)
    except ArchiveError as exc:
        sys.exit(str(exc))
    if result.nodes_imported == 0:
        print("nothing new to import (all archive nodes already present "
              "or content-equivalent)")


# ---------------------------------------------------------------------------
# chaos (docs/chaos.md)
# ---------------------------------------------------------------------------

def cmd_chaos_run(store: ProvenanceStore, args) -> None:
    from repro_torch.chaos.harness import SCENARIOS, run_scenario

    if args.scenario not in SCENARIOS:
        sys.exit(f"unknown scenario {args.scenario!r}; "
                 f"try: {', '.join(sorted(SCENARIOS))}")
    result = run_scenario(args.scenario, seed=args.seed,
                          workdir=args.workdir)
    if args.json:
        print(json.dumps({
            "scenario": result.name, "seed": result.seed, "ok": result.ok,
            "restarts": result.restarts, "elapsed": result.elapsed,
            "states": {str(k): v for k, v in result.states.items()},
            "violations": [str(v) for v in result.report.violations],
            "failures": result.failures,
            "broker_stats": result.broker_stats,
            "connect_wait": result.connect_wait,
            "workdir": result.workdir}, indent=2))
    else:
        print(result.summary())
    if not result.ok:
        sys.exit(1)


def cmd_chaos_list(store: ProvenanceStore, args) -> None:
    from repro_torch.chaos.harness import list_scenarios

    for sc in list_scenarios():
        print(f"{sc.name:<20} {sc.description}")
        if sc.chaos:
            print(f"{'':<20} faults: {sc.chaos}")


def cmd_chaos_points(store: ProvenanceStore, args) -> None:
    from repro_torch.chaos.faults import CATALOG

    for name, desc in sorted(CATALOG.items()):
        print(f"{name:<24} {desc}")


def cmd_chaos_check(store: ProvenanceStore, args) -> None:
    from repro_torch.chaos.invariants import check_store

    report = check_store(store, expected_pks=args.pk or None,
                         expect_terminal=args.expect_terminal)
    print(report.summary())
    if not report.ok:
        sys.exit(1)


def cmd_store_fsck(store: ProvenanceStore, args) -> None:
    from repro_torch.provenance.fsck import fsck

    broker_db = args.broker_db
    if broker_db is None:
        # daemon convention: broker.db sits next to the profile
        candidate = os.path.join(
            os.path.dirname(os.path.abspath(args.profile)), "broker.db")
        if os.path.exists(candidate):
            broker_db = candidate
    report = fsck(store, repair=args.repair, broker_db=broker_db)
    if args.json:
        print(json.dumps({
            "clean": report.clean,
            "repaired": report.repaired,
            "counts": report.counts(),
            "checked": {"processes": report.checked_processes,
                        "links": report.checked_links,
                        "blobs": report.checked_blobs},
            "findings": [{"kind": f.kind, "pk": f.pk, "detail": f.detail,
                          "action": f.action} for f in report.findings],
        }, indent=2))
    else:
        print(report.summary())
    # detect-only mode exits non-zero on findings (CI gate); --repair
    # exits zero when every finding was fixed
    if report.findings and not args.repair:
        sys.exit(1)


def cmd_cache_invalidate(store: ProvenanceStore, args) -> None:
    from repro_torch.caching.registry import CacheRegistry

    given = [args.all, args.pk is not None, bool(args.process_type)]
    if sum(given) != 1:
        sys.exit("give exactly one of --pk, --process-type or --all")
    n = CacheRegistry(store).invalidate(
        pk=args.pk, process_type=args.process_type or None)
    print(f"invalidated {n} node(s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.cli")
    ap.add_argument("-p", "--profile", default="examples_out/train_lm.db",
                    help="provenance sqlite file")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_proc = sub.add_parser("process")
    proc_sub = p_proc.add_subparsers(dest="sub", required=True)
    pl = proc_sub.add_parser("list")
    pl.add_argument("--state", default=None)
    pl.add_argument("--limit", type=int, default=30)
    pr = proc_sub.add_parser("report")
    pr.add_argument("pk", type=int)
    ps = proc_sub.add_parser("show")
    ps.add_argument("pk", type=int)
    pi = proc_sub.add_parser(
        "inputs", help="dump a process class's input/output spec")
    pi.add_argument("process_class",
                    help="e.g. repro_torch.calcjobs:GPUTrainJob or GPUTrainJob")
    for verb in ("pause", "play", "kill", "status"):
        pc = proc_sub.add_parser(verb)
        pc.add_argument("pk", type=int)
        pc.add_argument("-w", "--workdir", default=None,
                        help="daemon workdir holding broker.json "
                             "(default: profile directory)")
        if verb == "kill":
            pc.add_argument("--message", default="")
    pw = proc_sub.add_parser("watch")
    pw.add_argument("--pk", type=int, default=None)
    pw.add_argument("--once", action="store_true",
                    help="exit after the first event")
    pw.add_argument("--timeout", type=float, default=None,
                    help="stop watching after this many seconds")
    pw.add_argument("--replay", action="store_true",
                    help="first replay events the broker has logged")
    pw.add_argument("-w", "--workdir", default=None,
                    help="daemon workdir holding broker.json "
                         "(default: profile directory)")
    pt = proc_sub.add_parser(
        "top", help="live table of workers + the processes they drive")
    pt.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    pt.add_argument("--interval", type=float, default=2.0,
                    help="seconds between refreshes (default 2)")
    pt.add_argument("-w", "--workdir", default=None,
                    help="daemon workdir holding broker.json "
                         "(default: profile directory)")

    p_node = sub.add_parser("node")
    node_sub = p_node.add_subparsers(dest="sub", required=True)
    ns = node_sub.add_parser("show")
    ns.add_argument("pk", type=int)

    p_graph = sub.add_parser("graph")
    graph_sub = p_graph.add_subparsers(dest="sub", required=True)
    ge = graph_sub.add_parser("export")
    ge.add_argument("pk", type=int)
    ge.add_argument("--out", default="")
    ge.add_argument("--depth", type=int, default=3)

    p_stats = sub.add_parser("stats")
    p_stats.add_argument("--json", action="store_true",
                         help="machine-readable merged stats document")
    p_stats.add_argument("-w", "--workdir", default=None,
                         help="daemon workdir holding broker.json "
                              "(default: profile directory)")

    p_cache = sub.add_parser("cache")
    cache_sub = p_cache.add_subparsers(dest="sub", required=True)
    cache_sub.add_parser("stats")
    cs = cache_sub.add_parser("show")
    cs.add_argument("pk", type=int)
    ci = cache_sub.add_parser("invalidate")
    ci.add_argument("--pk", type=int, default=None)
    ci.add_argument("--process-type", default="")
    ci.add_argument("--all", action="store_true")
    cb = cache_sub.add_parser(
        "backfill", help="re-hash legacy (pre-caching) process nodes")
    cb.add_argument("--dry-run", action="store_true",
                    help="report what would be hashed without writing")
    cb.add_argument("--batch-size", type=int, default=200)
    cb.add_argument("--process-type", action="append", default=[],
                    help="only backfill these process types (repeatable)")
    cb.add_argument("--resolve", action="append", default=[],
                    metavar="MODULE",
                    help="extra module(s) to import process classes from")
    cb.add_argument("--include-invalidated", action="store_true",
                    help="also re-hash deliberately invalidated nodes")

    p_arch = sub.add_parser(
        "archive", help="export/import provenance between profiles")
    arch_sub = p_arch.add_subparsers(dest="sub", required=True)
    ac = arch_sub.add_parser("create")
    ac.add_argument("-o", "--output", required=True,
                    help="archive file to write (zip)")
    ac.add_argument("--pk", type=int, action="append", default=[],
                    help="seed node(s); the export is their graph closure")
    ac.add_argument("--all", action="store_true",
                    help="export the whole profile")
    ac.add_argument("--no-ancestors", action="store_true",
                    help="do not traverse to provenance ancestors")
    ac.add_argument("--no-descendants", action="store_true",
                    help="do not traverse to created data / sub-calls")
    ai = arch_sub.add_parser("inspect")
    ai.add_argument("archive")
    am = arch_sub.add_parser("import")
    am.add_argument("archive")
    am.add_argument("--no-dedup", action="store_true",
                    help="import content-equivalent finished-ok nodes "
                         "instead of mapping them onto existing ones")

    p_chaos = sub.add_parser(
        "chaos", help="fault injection scenarios + invariant checking")
    chaos_sub = p_chaos.add_subparsers(dest="sub", required=True)
    cr = chaos_sub.add_parser(
        "run", help="run one scenario against a throwaway daemon")
    cr.add_argument("--scenario", required=True)
    cr.add_argument("--seed", type=int, default=1)
    cr.add_argument("--workdir", default=None,
                    help="daemon workdir (default: fresh temp dir)")
    cr.add_argument("--json", action="store_true")
    chaos_sub.add_parser("list", help="list scenarios")
    chaos_sub.add_parser("points", help="list registered fault points")
    cc = chaos_sub.add_parser(
        "check", help="run the provenance invariant checker on the profile")
    cc.add_argument("--pk", type=int, action="append", default=[],
                    help="pk(s) that must exist (repeatable)")
    cc.add_argument("--expect-terminal", action="store_true",
                    help="also require --pk processes to be terminal")

    p_store = sub.add_parser(
        "store", help="profile maintenance (fsck, repair, blob GC)")
    store_sub = p_store.add_subparsers(dest="sub", required=True)
    sf = store_sub.add_parser(
        "fsck", help="detect (and with --repair, fix) orphaned processes, "
                     "stale checkpoints, dangling links, unreferenced blobs")
    sf.add_argument("--repair", action="store_true",
                    help="fix findings in place instead of just reporting")
    sf.add_argument("--broker-db", default=None,
                    help="broker sqlite for live-lease detection + requeue "
                         "(default: broker.db next to the profile)")
    sf.add_argument("--json", action="store_true")

    args = ap.parse_args(argv)
    store = ProvenanceStore(args.profile)

    if args.cmd == "process" and args.sub == "list":
        cmd_process_list(store, args)
    elif args.cmd == "process" and args.sub == "report":
        cmd_process_report(store, args)
    elif args.cmd == "process" and args.sub == "show":
        cmd_process_show(store, args)
    elif args.cmd == "process" and args.sub == "inputs":
        cmd_process_inputs(store, args)
    elif args.cmd == "process" and args.sub in ("pause", "play", "kill",
                                                "status"):
        cmd_process_control(store, args)
    elif args.cmd == "process" and args.sub == "watch":
        cmd_process_watch(store, args)
    elif args.cmd == "process" and args.sub == "top":
        cmd_process_top(store, args)
    elif args.cmd == "node" and args.sub == "show":
        cmd_node_show(store, args)
    elif args.cmd == "graph" and args.sub == "export":
        cmd_graph_export(store, args)
    elif args.cmd == "stats":
        cmd_stats(store, args)
    elif args.cmd == "cache" and args.sub == "stats":
        cmd_cache_stats(store, args)
    elif args.cmd == "cache" and args.sub == "show":
        cmd_cache_show(store, args)
    elif args.cmd == "cache" and args.sub == "invalidate":
        cmd_cache_invalidate(store, args)
    elif args.cmd == "cache" and args.sub == "backfill":
        cmd_cache_backfill(store, args)
    elif args.cmd == "archive" and args.sub == "create":
        cmd_archive_create(store, args)
    elif args.cmd == "archive" and args.sub == "inspect":
        cmd_archive_inspect(store, args)
    elif args.cmd == "archive" and args.sub == "import":
        cmd_archive_import(store, args)
    elif args.cmd == "chaos" and args.sub == "run":
        cmd_chaos_run(store, args)
    elif args.cmd == "chaos" and args.sub == "list":
        cmd_chaos_list(store, args)
    elif args.cmd == "chaos" and args.sub == "points":
        cmd_chaos_points(store, args)
    elif args.cmd == "chaos" and args.sub == "check":
        cmd_chaos_check(store, args)
    elif args.cmd == "store" and args.sub == "fsck":
        cmd_store_fsck(store, args)


if __name__ == "__main__":
    main()
