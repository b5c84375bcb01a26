"""Re-hash legacy (pre-caching) process nodes so they serve cache hits.

Databases created before the caching subsystem have ``node_hash = NULL``
on every process node, so none of that already-computed work can ever be
reused. The backfill walks cacheable process nodes that lack a
fingerprint, reconstructs each node's input mapping from its stored
``INPUT_*`` links, recomputes :func:`~repro_torch.caching.hashing.compute_input_hash`
with the *real* process class (so backfilled hashes are bit-identical to
the ones a fresh launch computes) and writes the result back — in
batches, idempotently, with ``--dry-run`` support and durable progress /
collision telemetry via ``ProvenanceStore.incr_meta``.

Nodes whose fingerprint was *deliberately* cleared with
``python -m repro_torch.cli cache invalidate`` carry a ``cache_invalidated`` attribute and
are skipped (pass ``include_invalidated=True`` to re-hash them anyway).
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

from repro_torch.caching.hashing import compute_input_hash
from repro_torch.provenance.store import (
    LinkType, NodeType, ProvenanceStore, QueryBuilder,
)

#: node types whose processes are hashable at all (mirrors
#: repro_torch.caching.config._is_cacheable's default)
_CACHEABLE_NODE_TYPES = (NodeType.CALC_FUNCTION, NodeType.CALC_JOB)

#: modules searched for process classes when no explicit registry is given
_DEFAULT_MODULES = ("repro_torch.calcjobs", "repro_torch.core")

_INPUT_LINKS = (LinkType.INPUT_CALC.value, LinkType.INPUT_WORK.value)

#: meta keys for durable backfill telemetry (shown by `cache stats`
#: consumers via ProvenanceStore.all_meta)
META_HASHED = "cache_backfill.hashed"
META_RUNS = "cache_backfill.runs"


@dataclass
class BackfillStats:
    scanned: int = 0
    hashed: int = 0
    skipped_unresolvable: int = 0
    skipped_invalidated: int = 0
    skipped_error: int = 0
    collisions: int = 0
    dry_run: bool = False
    #: process_type -> count of nodes hashed
    by_type: dict[str, int] = field(default_factory=dict)

    @property
    def skipped(self) -> int:
        return (self.skipped_unresolvable + self.skipped_invalidated +
                self.skipped_error)


class ClassResolver:
    """Map a stored ``process_type`` name back to its Process class.

    Resolution order: an explicit ``classes`` mapping, then attribute
    lookup in ``modules`` (process-function wrappers are unwrapped via
    their ``process_class``). The stored name is the class ``__name__``,
    so callers with processes defined outside the default modules pass
    their module paths (CLI: ``--resolve mypkg.flows``).
    A module of the reference package is refused before anything is
    imported (``refuse_reference``).
    """

    def __init__(self, classes: Mapping[str, type] | None = None,
                 modules: Iterable[str] = ()):
        from repro_torch.core.process import Process, refuse_reference

        self._process_base = Process
        self._registry: dict[str, type | None] = dict(classes or {})
        modules = tuple(modules)
        for name in modules:
            refuse_reference(name, f"resolver module {name!r}")
        self._modules = []
        for name in (*modules, *_DEFAULT_MODULES):
            try:
                self._modules.append(importlib.import_module(name))
            except ImportError:
                pass

    def resolve(self, process_type: str) -> type | None:
        if process_type in self._registry:
            return self._registry[process_type]
        found: type | None = None
        for mod in self._modules:
            obj = getattr(mod, process_type, None)
            if obj is None:
                continue
            if isinstance(obj, type) and issubclass(obj, self._process_base):
                found = obj
                break
            proc_cls = getattr(obj, "process_class", None)
            if isinstance(proc_cls, type) and \
                    issubclass(proc_cls, self._process_base):
                found = proc_cls
                break
        self._registry[process_type] = found   # cache misses too
        return found


def _inputs_from_links(store: ProvenanceStore, pk: int, ns) -> dict:
    """Rebuild the (db-stored part of the) input mapping of a process
    node from its incoming INPUT_* links, un-flattening ``a__b`` labels
    against the class's port tree the same way the cache-clone path does:
    a ``__`` segment descends only when the prefix names a declared
    PortNamespace (or lands in a dynamic namespace); a flat label that
    merely contains ``__`` stays flat."""
    from repro_torch.core.ports import PortNamespace

    tree: dict = {}
    for src_pk, lt, label in store.incoming(pk):
        if lt not in _INPUT_LINKS:
            continue
        value = store.load_data(src_pk)
        parts = label.split("__")
        cur_ns, cur = ns, tree
        while len(parts) > 1:
            head = parts[0]
            port = cur_ns.get(head) if cur_ns is not None else None
            if isinstance(port, PortNamespace):
                cur = cur.setdefault(head, {})
                cur_ns = port
                parts = parts[1:]
                continue
            if port is None and cur_ns is not None and \
                    getattr(cur_ns, "dynamic", False) and len(parts) == 2:
                # dynamic-namespace mapping values link as <key>__<sub>
                cur = cur.setdefault(head, {})
                cur_ns = None
                parts = parts[1:]
                continue
            break  # flat label that happens to contain '__'
        cur["__".join(parts)] = value
    return tree


def backfill_hashes(store: ProvenanceStore, *,
                    classes: Mapping[str, type] | None = None,
                    resolve_modules: Iterable[str] = (),
                    process_types: Iterable[str] | None = None,
                    batch_size: int = 200,
                    dry_run: bool = False,
                    include_invalidated: bool = False,
                    collision_check: bool = True,
                    progress: Callable[[str], None] | None = None
                    ) -> BackfillStats:
    """Fingerprint every cacheable process node with ``node_hash = NULL``.

    Idempotent: re-running scans only nodes still lacking a hash, so a
    completed backfill is a no-op. ``dry_run`` computes and reports
    without writing anything — no hashes, no telemetry, and the
    collision probe is skipped too (its registry lookups memoize output
    digests into node attributes, which a dry run must not do).
    """
    stats = BackfillStats(dry_run=dry_run)
    say = progress or (lambda _msg: None)
    resolver = ClassResolver(classes, resolve_modules)
    wanted = set(process_types) if process_types else None
    registry = None
    if collision_check and not dry_run:
        from repro_torch.caching.registry import CacheRegistry

        registry = CacheRegistry(store)

    qb = (QueryBuilder(store)
          .with_node_types(_CACHEABLE_NODE_TYPES)
          .with_null_hash()
          .order_by("pk"))
    candidates = [row for row in qb.all()
                  if wanted is None or row["process_type"] in wanted]

    for start in range(0, len(candidates), batch_size):
        batch = candidates[start:start + batch_size]
        for row in batch:
            stats.scanned += 1
            attrs = json.loads(row.get("attributes") or "{}")
            if attrs.get("cache_invalidated") and not include_invalidated:
                stats.skipped_invalidated += 1
                continue
            cls = resolver.resolve(row["process_type"] or "")
            if cls is None:
                stats.skipped_unresolvable += 1
                continue
            try:
                ns = cls.spec().inputs
                inputs = _inputs_from_links(store, row["pk"], ns)
                node_hash = compute_input_hash(cls, inputs, ns=ns)
            except Exception:  # noqa: BLE001 — one bad node must not
                stats.skipped_error += 1       # abort the whole backfill
                continue
            if registry is not None and \
                    row.get("process_state") == "finished" and \
                    row.get("exit_status") == 0:
                # would this node join an equivalence class whose outputs
                # disagree with its own? count it like the hit-path does
                hit = registry.find_cached(row["process_type"], node_hash,
                                           exclude_pk=row["pk"])
                if hit is not None:
                    try:
                        mine = registry._output_digest_for(row["pk"])
                        theirs = registry._output_digest_for(hit.pk,
                                                             hit.outputs)
                        if mine != theirs:
                            stats.collisions += 1
                            store.incr_meta(
                                f"{registry.COLLISION_KEY}."
                                f"{row['process_type']}")
                    except Exception:  # noqa: BLE001 — telemetry only
                        pass
            if not dry_run:
                store.set_node_hash(row["pk"], node_hash)
            stats.hashed += 1
            stats.by_type[row["process_type"]] = \
                stats.by_type.get(row["process_type"], 0) + 1
        done = min(start + batch_size, len(candidates))
        say(f"  batch {start // batch_size + 1}: "
            f"{done}/{len(candidates)} scanned, {stats.hashed} hashed"
            + (" (dry run)" if dry_run else ""))

    if not dry_run and stats.hashed:
        store.incr_meta(META_HASHED, stats.hashed)
    if not dry_run:
        store.incr_meta(META_RUNS)
    return stats
