"""Provenance archives: export / import between profiles (AiiDA 1.0 §export).

Provenance is only valuable if it travels: the engine records the full
directed graph of calculations and data precisely so results can be
shared, re-imported and *reused* elsewhere. An archive is a versioned zip
holding a closed subgraph — every exported process node carries its
complete input set — plus logs, array payloads and the ``node_hash`` /
``cached_from`` cache metadata. Importing an archive into another
profile's store merges the graph (nodes keep their uuid, pks are
remapped) and makes every imported finished-ok node an immediate cache
source: one user's computed results short-circuit another profile's
launches through the ordinary :class:`~repro_torch.caching.registry.CacheRegistry`
lookup.

Archive layout (``ARCHIVE_VERSION`` 1)::

    manifest.json      version, counts, node-type histogram, content digest
    nodes.jsonl        one node record per line, sorted by uuid (no pks)
    links.jsonl        {in, out, type, label} with uuid endpoints, sorted
    logs.jsonl         {node, levelname, message, time}, sorted
    payloads/<uuid>.npy  raw .npy bytes of ArrayData nodes (kept out of
                         the jsonl so arrays are stored once, uncompressed
                         by base64, and inspectable with numpy directly)

Everything inside the zip is pk-free and deterministically ordered, so
export → import → export reproduces a byte-identical content digest (the
round-trip property the tests assert).
"""

from __future__ import annotations

import base64
import json
import zipfile
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from repro_torch.provenance.store import LinkType, ProvenanceStore

ARCHIVE_VERSION = 1

#: links that flow "downstream" from a process: results and sub-calls
_OUTPUT_LINKS = (LinkType.CREATE.value, LinkType.RETURN.value)
_CALL_LINKS = (LinkType.CALL_CALC.value, LinkType.CALL_WORK.value)
_INPUT_LINKS = (LinkType.INPUT_CALC.value, LinkType.INPUT_WORK.value)

#: fixed zip member timestamp — archives with equal content are equal bytes
_ZIP_DATE = (1980, 1, 1, 0, 0, 0)


class ArchiveError(RuntimeError):
    """Malformed or incompatible archive."""


# ---------------------------------------------------------------------------
# graph traversal
# ---------------------------------------------------------------------------

#: below this many total links the traversal preloads the whole link table
#: (two projected scans) and walks in memory — killing the per-level query
#: cost entirely; deep chains would otherwise still pay one query per level
_CLOSURE_PRELOAD_MAX_LINKS = 500_000


def compute_closure(store: ProvenanceStore, pks: Iterable[int], *,
                    ancestors: bool = True,
                    descendants: bool = True) -> set[int]:
    """The closed node set reachable from a selection.

    Traversal rules, applied to a worklist until fixpoint:

    * **always** — a process node pulls in its direct inputs (incoming
      ``INPUT_*`` links), so every exported process is complete and its
      ``node_hash`` is justified by data actually present in the archive;
    * **ancestors** — a data node pulls in its creator (incoming
      ``CREATE``/``RETURN``), a process pulls in its caller workflow
      (incoming ``CALL_*``): the full provenance history of the selection;
    * **descendants** — a process pulls in the data it created/returned
      (outgoing ``CREATE``/``RETURN``) and the subprocesses it called
      (outgoing ``CALL_*``). Outgoing ``INPUT_*`` links from data nodes
      are deliberately *not* followed: that would drag in every unrelated
      calculation that ever consumed a shared input.

    The walk is batched: small/medium graphs preload links + process-pk
    membership in two projected scans (no payload text is ever fetched),
    larger ones expand one BFS *level* per ``links_for``/``get_nodes``
    round trip instead of three queries per node.
    """
    seeds = {int(pk) for pk in pks}
    if not seeds:
        return set()
    found = store.get_nodes(seeds, columns=("pk",))
    missing = seeds - found.keys()
    if missing:
        raise KeyError(f"no node with pk={min(missing)}")

    if store.count_links() <= _CLOSURE_PRELOAD_MAX_LINKS:
        return _closure_preloaded(store, seeds, ancestors, descendants)
    return _closure_levelwise(store, seeds, ancestors, descendants)


def _expand(pk: int, is_process: bool,
            incoming: list[tuple[int, str]], outgoing: list[tuple[int, str]],
            ancestors: bool, descendants: bool) -> Iterable[int]:
    """Apply the traversal rules to one node's edge lists."""
    for src, lt in incoming:
        if is_process and lt in _INPUT_LINKS:
            yield src                                   # always: closure
        elif ancestors and not is_process and lt in _OUTPUT_LINKS:
            yield src                                   # creator
        elif ancestors and is_process and lt in _CALL_LINKS:
            yield src                                   # caller
    if descendants and is_process:
        for dst, lt in outgoing:
            if lt in _OUTPUT_LINKS or lt in _CALL_LINKS:
                yield dst


def _closure_preloaded(store: ProvenanceStore, seeds: set[int],
                       ancestors: bool, descendants: bool) -> set[int]:
    # raw-tuple cursor: this loop touches every link row, so Row-object
    # construction would dominate the traversal
    cur = store._conn().cursor()
    cur.row_factory = None
    cur.execute("SELECT pk FROM nodes WHERE node_type LIKE 'process%'")
    process_pks = {pk for (pk,) in cur.fetchall()}
    # bake the traversal rules into the adjacency at load time: one pass
    # categorizes every link, leaving a pure integer-graph BFS
    follow: dict[int, list[int]] = {}
    cur.execute("SELECT in_id, out_id, link_type FROM links")
    for in_id, out_id, lt in cur.fetchall():
        if lt in _INPUT_LINKS:
            if out_id in process_pks:
                follow.setdefault(out_id, []).append(in_id)   # always
        elif lt in _OUTPUT_LINKS:
            if ancestors and out_id not in process_pks:
                follow.setdefault(out_id, []).append(in_id)   # creator
            if descendants and in_id in process_pks:
                follow.setdefault(in_id, []).append(out_id)   # created
        elif lt in _CALL_LINKS:
            if ancestors and out_id in process_pks:
                follow.setdefault(out_id, []).append(in_id)   # caller
            if descendants and in_id in process_pks:
                follow.setdefault(in_id, []).append(out_id)   # callee
    seen: set[int] = set()
    frontier = list(seeds)
    while frontier:
        pk = frontier.pop()
        if pk in seen:
            continue
        seen.add(pk)
        nxt = follow.get(pk)
        if nxt:
            frontier.extend(nxt)
    return seen


def _closure_levelwise(store: ProvenanceStore, seeds: set[int],
                       ancestors: bool, descendants: bool) -> set[int]:
    seen: set[int] = set()
    is_process: dict[int, bool] = {}
    frontier = set(seeds)
    while frontier:
        unknown = [pk for pk in frontier if pk not in is_process]
        for pk, row in store.get_nodes(unknown,
                                       columns=("pk", "node_type")).items():
            is_process[pk] = row["node_type"].startswith("process")
        inc: dict[int, list[tuple[int, str]]] = {}
        out: dict[int, list[tuple[int, str]]] = {}
        for in_id, out_id, lt, _label in store.links_for(frontier):
            inc.setdefault(out_id, []).append((in_id, lt))
            out.setdefault(in_id, []).append((out_id, lt))
        seen |= frontier
        nxt: set[int] = set()
        for pk in frontier:
            nxt.update(_expand(pk, is_process[pk], inc.get(pk, ()),
                               out.get(pk, ()), ancestors, descendants))
        frontier = nxt - seen
    return seen


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

_NODE_FIELDS = ("uuid", "node_type", "process_type", "label", "description",
                "process_state", "exit_status", "exit_message", "node_hash",
                "ctime", "mtime")


def _node_record(store: ProvenanceStore, node: dict
                 ) -> tuple[dict, bytes | None]:
    """The archive representation of one node row: a pk-free JSON record,
    plus raw ``.npy`` bytes when the payload is an array (stored as a
    separate zip member referenced by uuid). Repository-backed payloads
    are resolved here, so the archive format is identical whether the
    source profile kept the content inline or in its blob store."""
    record = {f: node.get(f) for f in _NODE_FIELDS}
    record["attributes"] = json.loads(node.get("attributes") or "{}")
    # runtime attributes make no sense across profiles, and pks are
    # profile-local — `cached_from` (a uuid) is the durable reference,
    # `cached_from_pk` is reconstructed at import time
    record["attributes"].pop("kill_requested", None)
    record["attributes"].pop("paused", None)
    record["attributes"].pop("cached_from_pk", None)
    payload = node.get("payload")
    npy: bytes | None = None
    if payload is not None:
        doc = json.loads(payload)
        if doc.get("type") == "array" and "blob" in doc:
            # blob-backed array: raw bytes straight from the repository
            npy = store.repository.get(doc["blob"])
            doc = {"type": "array", "npy_ref": f"payloads/{node['uuid']}.npy"}
        elif doc.get("type") == "array" and "npy_b64" in doc:
            npy = base64.b64decode(doc["npy_b64"])
            doc = {"type": "array", "npy_ref": f"payloads/{node['uuid']}.npy"}
        else:
            # folders (and anything else) travel inline in nodes.jsonl
            doc = store.materialize_payload(doc)
        record["payload"] = doc
    else:
        record["payload"] = None
    return record, npy


def _canonical(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _content_digest(nodes: list[dict], links: list[dict],
                    logs: list[dict]) -> str:
    import hashlib

    h = hashlib.sha256()
    for section in (nodes, links, logs):
        for rec in section:
            h.update(_canonical(rec).encode())
            h.update(b"\n")
    return h.hexdigest()


def export_archive(store: ProvenanceStore, path: str,
                   pks: Iterable[int] | None = None, *,
                   ancestors: bool = True, descendants: bool = True,
                   source: str = "") -> dict:
    """Write the closure of ``pks`` (default: every node) to a zip archive
    at ``path``; returns the manifest."""
    if pks is None:
        rows = store._conn().execute("SELECT pk FROM nodes").fetchall()
        selection = {r["pk"] for r in rows}
    else:
        selection = compute_closure(store, pks, ancestors=ancestors,
                                    descendants=descendants)

    node_records: list[dict] = []
    payloads: dict[str, bytes] = {}
    uuid_of: dict[int, str] = {}
    # batched, one pass; checkpoints never enter an archive, so don't
    # drag live processes' checkpoint text through the row cache
    from repro_torch.provenance.store import SUMMARY_COLUMNS
    rows_by_pk = store.get_nodes(selection,
                                 columns=(*SUMMARY_COLUMNS, "payload"))
    for pk in sorted(selection):
        node = rows_by_pk.get(pk)
        if node is None:
            raise KeyError(f"no node with pk={pk}")
        record, npy = _node_record(store, node)
        uuid_of[pk] = node["uuid"]
        node_records.append(record)
        if npy is not None:
            payloads[f"payloads/{node['uuid']}.npy"] = npy
    node_records.sort(key=lambda r: r["uuid"])

    # endpoint filtering happens in python: an IN (…) pair over the whole
    # selection would blow sqlite's bound-variable limit on large profiles
    rows = store._conn().execute(
        "SELECT in_id, out_id, link_type, label FROM links").fetchall()
    link_records = [{"in": uuid_of[r["in_id"]],
                     "out": uuid_of[r["out_id"]],
                     "type": r["link_type"], "label": r["label"]}
                    for r in rows
                    if r["in_id"] in selection and r["out_id"] in selection]
    link_records.sort(key=lambda r: (r["in"], r["out"], r["type"],
                                     r["label"]))

    log_records: list[dict] = []
    for pk, entries in store.logs_for(sorted(selection)).items():
        for entry in entries:
            log_records.append({"node": uuid_of[pk],
                                "levelname": entry["levelname"],
                                "message": entry["message"],
                                "time": entry["time"]})
    log_records.sort(key=lambda r: (r["node"], r["time"], r["message"]))

    types: dict[str, int] = {}
    for rec in node_records:
        types[rec["node_type"]] = types.get(rec["node_type"], 0) + 1
    manifest = {
        "archive_version": ARCHIVE_VERSION,
        "source": source,
        "nodes": len(node_records),
        "links": len(link_records),
        "logs": len(log_records),
        "payload_files": len(payloads),
        "node_types": dict(sorted(types.items())),
        "content_digest": _content_digest(node_records, link_records,
                                          log_records),
    }

    def _jsonl(records: list[dict]) -> str:
        return "".join(_canonical(r) + "\n" for r in records)

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        def write(name: str, data: bytes | str) -> None:
            info = zipfile.ZipInfo(name, date_time=_ZIP_DATE)
            info.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(info, data)

        write("manifest.json", json.dumps(manifest, indent=1,
                                          sort_keys=True))
        write("nodes.jsonl", _jsonl(node_records))
        write("links.jsonl", _jsonl(link_records))
        write("logs.jsonl", _jsonl(log_records))
        for name in sorted(payloads):
            write(name, payloads[name])
    return manifest


# ---------------------------------------------------------------------------
# inspect
# ---------------------------------------------------------------------------

def _open_zip(path: str) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(path)
    except (zipfile.BadZipFile, OSError) as exc:
        raise ArchiveError(f"{path}: cannot open archive: {exc}") from exc


def read_manifest(path: str) -> dict:
    with _open_zip(path) as zf:
        try:
            raw = zf.read("manifest.json")
        except KeyError as exc:
            raise ArchiveError(f"{path}: not a provenance archive "
                               "(no manifest.json)") from exc
    manifest = json.loads(raw)
    version = manifest.get("archive_version")
    if version != ARCHIVE_VERSION:
        raise ArchiveError(
            f"{path}: archive version {version!r} is not supported "
            f"(this build reads version {ARCHIVE_VERSION})")
    return manifest


def _read_jsonl(zf: zipfile.ZipFile, name: str) -> list[dict]:
    try:
        raw = zf.read(name)
    except KeyError:
        return []
    return [json.loads(line) for line in raw.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

@dataclass
class ImportResult:
    nodes_imported: int = 0
    #: archive nodes already present in the target store (same uuid)
    nodes_existing: int = 0
    #: archive process nodes skipped because an equivalent finished-ok
    #: node (same process_type + node_hash) already exists in the target
    nodes_deduped: int = 0
    #: archive nodes whose every link touches a deduped node — their
    #: content already exists attached to the target's equivalent, so
    #: importing them would create provenance-less orphans
    nodes_skipped_orphaned: int = 0
    links_imported: int = 0
    logs_imported: int = 0
    #: archive uuid -> target-store pk (existing, deduped-to or new)
    pk_map: dict[str, int] = field(default_factory=dict)

    @property
    def nodes_seen(self) -> int:
        return (self.nodes_imported + self.nodes_existing +
                self.nodes_deduped + self.nodes_skipped_orphaned)


def _dedup_target(store: ProvenanceStore, record: dict) -> dict | None:
    """An existing finished-ok node in the target store that is
    content-equivalent to this archive process record, or None."""
    if not record["node_type"].startswith("process"):
        return None
    if not record.get("node_hash"):
        return None
    if record.get("process_state") != "finished" or \
            record.get("exit_status") != 0:
        return None
    row = store._conn().execute(
        "SELECT * FROM nodes WHERE process_type=? AND node_hash=?"
        " AND process_state='finished' AND exit_status=0"
        " ORDER BY pk LIMIT 1",
        (record.get("process_type"), record["node_hash"])).fetchone()
    return dict(row) if row else None


def import_archive(store: ProvenanceStore, path: str, *,
                   dedup: bool = True,
                   progress: Callable[[str], None] | None = None
                   ) -> ImportResult:
    """Merge an archive into ``store``.

    * nodes keep their uuid; a uuid already present in the target maps to
      the existing node and is not re-inserted (re-imports are no-ops);
    * with ``dedup`` (default), a finished-ok process node whose
      ``(process_type, node_hash)`` already exists finished-ok in the
      target is *not* duplicated — the archive uuid maps to the existing
      equivalent node, the archive links/logs touching the skipped node
      are dropped (the existing node already carries its own complete
      provenance), and archive nodes *all of whose* links touch deduped
      nodes (a deduped calc's private inputs/outputs) are skipped too,
      so dedup never strands orphan data nodes;
    * links and logs are imported with endpoints remapped through the
      uuid -> pk map; exact-duplicate links are skipped, so importing
      overlapping archives cannot double-link the graph;
    * ``cached_from_pk`` attributes are rewritten to target pks when the
      referenced uuid is resolvable (the uuid in ``cached_from`` is the
      durable cross-profile reference).

    The whole merge is one store transaction: a malformed archive (e.g.
    missing payload member) rolls back cleanly instead of leaving a
    half-imported profile.
    """
    manifest = read_manifest(path)
    result = ImportResult()
    say = progress or (lambda _msg: None)

    with _open_zip(path) as zf:
        nodes = _read_jsonl(zf, "nodes.jsonl")
        links = _read_jsonl(zf, "links.jsonl")
        logs = _read_jsonl(zf, "logs.jsonl")

        # pass 1 (read-only): classify every archive node
        new_records: list[dict] = []
        deduped_uuids: set[str] = set()
        for record in nodes:
            uuid = record["uuid"]
            existing = store.get_node_by_uuid(uuid)
            if existing is not None:
                result.pk_map[uuid] = existing["pk"]
                result.nodes_existing += 1
                continue
            if dedup:
                equivalent = _dedup_target(store, record)
                if equivalent is not None:
                    result.pk_map[uuid] = equivalent["pk"]
                    result.nodes_deduped += 1
                    deduped_uuids.add(uuid)
                    continue
            new_records.append(record)

        # a new node whose every archive link touches a deduped node would
        # import with no edges at all (its links are dropped below) — its
        # content already lives attached to the target's equivalent node
        partners: dict[str, list[str]] = {}
        for link in links:
            partners.setdefault(link["in"], []).append(link["out"])
            partners.setdefault(link["out"], []).append(link["in"])
        orphaned = {r["uuid"] for r in new_records
                    if partners.get(r["uuid"]) and
                    all(p in deduped_uuids for p in partners[r["uuid"]])}
        result.nodes_skipped_orphaned = len(orphaned)

        # pass 2: one atomic merge, bulk inserts (executemany) throughout
        new_uuids: set[str] = set()
        with store.transaction():
            to_insert: list[dict] = []
            for record in new_records:
                uuid = record["uuid"]
                if uuid in orphaned:
                    continue
                payload = record.get("payload")
                if isinstance(payload, dict) and payload.get("npy_ref"):
                    try:
                        npy = zf.read(payload["npy_ref"])
                    except KeyError as exc:
                        raise ArchiveError(
                            f"{path}: missing payload member "
                            f"{payload['npy_ref']!r}") from exc
                    payload = {"type": "array",
                               "npy_b64": base64.b64encode(npy).decode()}
                row = dict(record)
                # a payload document goes in as-is: insert_node_rows
                # serializes canonically and routes bulk content above the
                # inline threshold to the blob repository (dedup by digest)
                row["payload"] = payload
                to_insert.append(row)
                new_uuids.add(uuid)
            for pk, row in zip(store.insert_node_rows(to_insert), to_insert):
                result.pk_map[row["uuid"]] = pk
            result.nodes_imported = len(to_insert)
            if to_insert:
                say(f"  {result.nodes_imported} nodes inserted...")

            link_rows: list[tuple[int, int, LinkType, str]] = []
            for link in links:
                if link["in"] in deduped_uuids or \
                        link["out"] in deduped_uuids:
                    continue
                in_pk = result.pk_map.get(link["in"])
                out_pk = result.pk_map.get(link["out"])
                if in_pk is None or out_pk is None:
                    continue  # endpoint outside the archive and the target
                lt = LinkType(link["type"])
                # fast path: links between two *new* nodes cannot pre-exist
                if not (link["in"] in new_uuids and
                        link["out"] in new_uuids) \
                        and store.has_link(in_pk, out_pk, lt, link["label"]):
                    continue
                link_rows.append((in_pk, out_pk, lt, link["label"]))
            store.add_links(link_rows)
            result.links_imported = len(link_rows)

            store.add_logs([(result.pk_map[e["node"]], e["levelname"],
                             e["message"], e["time"])
                            for e in logs if e["node"] in new_uuids])
            result.logs_imported = sum(
                1 for e in logs if e["node"] in new_uuids)

            # reconstruct cached_from_pk from the durable uuid reference;
            # raw SQL (not update_process) so the imported node's mtime
            # stays what the archive says it is
            for uuid in new_uuids:
                pk = result.pk_map[uuid]
                node = store.get_node(pk) or {}
                attrs = json.loads(node.get("attributes") or "{}")
                src_uuid = attrs.get("cached_from")
                if not src_uuid:
                    continue
                src = store.get_node_by_uuid(src_uuid)
                if src is None:
                    continue  # source outside archive and target store
                attrs["cached_from_pk"] = src["pk"]
                store._conn().execute(
                    "UPDATE nodes SET attributes=? WHERE pk=?",
                    (json.dumps(attrs), pk))

    say(f"imported {result.nodes_imported} node(s), "
        f"{result.links_imported} link(s), {result.logs_imported} log(s); "
        f"{result.nodes_existing} already present, "
        f"{result.nodes_deduped} deduplicated by content hash "
        f"(manifest digest {manifest['content_digest'][:12]}...)")
    return result
