"""Cache lookups over the provenance graph.

The provenance store itself is the cache: every process node records its
input fingerprint in the indexed ``node_hash`` column, so a lookup is one
SELECT over ``(process_type, node_hash)``. Only *finished-ok* nodes serve
as sources; invalidation simply clears ``node_hash`` on the source nodes
(their provenance is untouched — they just stop matching).
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
from dataclasses import dataclass, field
from typing import Any

from repro_torch.provenance.store import LinkType, ProvenanceStore, QueryBuilder

_OUTPUT_LINKS = (LinkType.CREATE.value, LinkType.RETURN.value)


@dataclass
class CacheHit:
    pk: int
    uuid: str
    process_type: str
    exit_status: int
    exit_message: str | None
    # (label, link_type value, data node pk) for each CREATE/RETURN edge
    outputs: list[tuple[str, str, int]] = field(default_factory=list)


class CacheRegistry:
    def __init__(self, store: ProvenanceStore):
        self.store = store

    #: key prefix for the per-process-type hash-collision counters
    COLLISION_KEY = "cache_collisions"
    #: how many equivalent sources to cross-check per cache hit (bounds
    #: the extra payload loads on the hot path)
    _COLLISION_PROBE = 2

    def find_cached(self, process_type: str, input_hash: str,
                    exclude_pk: int | None = None) -> CacheHit | None:
        """Most recent finished-ok node with this fingerprint, plus its
        output edges — or None. When several finished-ok sources share the
        fingerprint, their outputs are cross-checked by content: a
        same-hash/different-outputs pair is a *hash collision* (the
        fingerprint failed to capture something that changed the result)
        and increments the durable ``cache_collisions.<type>`` counter
        surfaced by ``repro cache stats``."""
        if not input_hash:
            return None
        rows = (QueryBuilder(self.store)
                .with_process_type(process_type)
                .with_hash(input_hash)
                .with_state("finished")
                .with_exit_status(0)
                .order_by("pk", desc=True)
                .limit(2 + self._COLLISION_PROBE)
                .project("pk", "uuid", "exit_status", "exit_message")
                .all())
        viable = [row for row in rows
                  if exclude_pk is None or row["pk"] != exclude_pk]
        if not viable:
            return None
        row = viable[0]
        outputs = [(label, lt, pk)
                   for pk, lt, label in self.store.outgoing(row["pk"])
                   if lt in _OUTPUT_LINKS]
        if len(viable) > 1:
            self._record_collisions(process_type, row["pk"], outputs,
                                    viable[1:])
        return CacheHit(pk=row["pk"], uuid=row["uuid"],
                        process_type=process_type,
                        exit_status=row["exit_status"],
                        exit_message=row["exit_message"],
                        outputs=outputs)

    # -- hash-collision telemetry -------------------------------------------
    def _output_digest(self, outputs: list[tuple[str, str, int]]) -> str:
        """Content digest of a node's output set: sorted (label, link
        type, payload hash) triples — node identity does not matter."""
        from repro_torch.caching.hashing import hash_data_value

        triples = sorted(
            (label, lt, hash_data_value(self.store.load_data(pk)))
            for label, lt, pk in outputs)
        return hashlib.sha256(
            json.dumps(triples, sort_keys=True).encode()).hexdigest()

    def _output_digest_for(self, pk: int,
                           outputs: list[tuple[str, str, int]] | None = None
                           ) -> str:
        """The node's output digest, memoized in its attributes — the
        probe on the cache-hit hot path must not re-load full payloads
        (arrays, folders) on every lookup. Clones inherit the digest from
        their source via the attribute carry-over, which is sound because
        their outputs are content-identical by construction."""
        attrs = json.loads(
            (self.store.get_node(pk, columns=("attributes",)) or {})
            .get("attributes") or "{}")
        cached = attrs.get("output_digest")
        if cached:
            return cached
        if outputs is None:
            outputs = [(label, lt, out_pk)
                       for out_pk, lt, label in self.store.outgoing(pk)
                       if lt in _OUTPUT_LINKS]
        digest = self._output_digest(outputs)
        self.store.update_process(pk, attributes={"output_digest": digest})
        return digest

    def _record_collisions(self, process_type: str, hit_pk: int,
                           hit_outputs: list[tuple[str, str, int]],
                           others: list[dict]) -> None:
        """Count same-``node_hash``/different-outputs occurrences on the
        cache-hit path (bounded probe; telemetry must never break a run)."""
        try:
            reference = self._output_digest_for(hit_pk, hit_outputs)
            for row in others[:self._COLLISION_PROBE]:
                if self._output_digest_for(row["pk"]) != reference:
                    self.store.incr_meta(
                        f"{self.COLLISION_KEY}.{process_type}")
                    break   # one occurrence per lookup, not per pair
        except Exception:  # noqa: BLE001 — telemetry only
            pass

    def collision_counts(self) -> dict[str, int]:
        """Per-process-type hash-collision occurrence counters."""
        prefix = f"{self.COLLISION_KEY}."
        return {key[len(prefix):]: int(value) for key, value
                in self.store.all_meta(prefix).items()}

    # -- observability ------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """Per-process-type hashed-node counts, distinct fingerprints and
        cache-hit (cloned) node counts."""
        conn = self.store._conn()
        rows = conn.execute(
            "SELECT process_type, COUNT(*) AS n,"
            " COUNT(DISTINCT node_hash) AS distinct_hashes,"
            " SUM(CASE WHEN json_extract(attributes, '$.cached_from')"
            "     IS NOT NULL THEN 1 ELSE 0 END) AS hits"
            " FROM nodes WHERE node_hash IS NOT NULL"
            " AND node_type LIKE 'process%'"
            " GROUP BY process_type ORDER BY process_type").fetchall()
        collisions = self.collision_counts()
        per_type = {r["process_type"]: {
            "hashed_nodes": r["n"],
            "distinct_hashes": r["distinct_hashes"],
            "cache_hits": r["hits"] or 0,
            "hash_collisions": collisions.get(r["process_type"], 0),
        } for r in rows}
        return {
            "process_types": per_type,
            "hashed_nodes": sum(v["hashed_nodes"] for v in per_type.values()),
            "cache_hits": sum(v["cache_hits"] for v in per_type.values()),
            "hash_collisions": sum(collisions.values()),
        }

    def equivalents(self, pk: int) -> list[int]:
        """Other process nodes sharing this node's fingerprint."""
        node = self.store.get_node(pk)
        if not node or not node.get("node_hash"):
            return []
        rows = (QueryBuilder(self.store)
                .with_hash(node["node_hash"]).project("pk").all())
        return [r["pk"] for r in rows if r["pk"] != pk]

    # -- invalidation --------------------------------------------------------
    def invalidate(self, *, pk: int | None = None,
                   process_type: str | None = None) -> int:
        """Clear fingerprints so nodes stop serving as cache sources.
        Give a pk, a process_type, or neither (= everything). Returns the
        number of nodes invalidated."""
        conn = self.store._conn()
        # also stamp `cache_invalidated` so `repro cache backfill` knows
        # the cleared fingerprint was deliberate and must not be restored
        mark = ("attributes=json_patch(COALESCE(attributes,'{}'),"
                " '{\"cache_invalidated\": true}')")
        with self.store._lock:
            try:
                if pk is not None:
                    cur = conn.execute(
                        f"UPDATE nodes SET node_hash=NULL, {mark} WHERE pk=?"
                        " AND node_hash IS NOT NULL", (pk,))
                elif process_type is not None:
                    cur = conn.execute(
                        f"UPDATE nodes SET node_hash=NULL, {mark}"
                        " WHERE process_type=?"
                        " AND node_hash IS NOT NULL", (process_type,))
                else:
                    cur = conn.execute(
                        f"UPDATE nodes SET node_hash=NULL, {mark}"
                        " WHERE node_hash IS NOT NULL")
            except sqlite3.OperationalError:
                # sqlite built without JSON1: clear the hashes unmarked
                # (backfill may then re-fingerprint these nodes)
                if pk is not None:
                    cur = conn.execute(
                        "UPDATE nodes SET node_hash=NULL WHERE pk=?"
                        " AND node_hash IS NOT NULL", (pk,))
                elif process_type is not None:
                    cur = conn.execute(
                        "UPDATE nodes SET node_hash=NULL WHERE process_type=?"
                        " AND node_hash IS NOT NULL", (process_type,))
                else:
                    cur = conn.execute(
                        "UPDATE nodes SET node_hash=NULL"
                        " WHERE node_hash IS NOT NULL")
            conn.commit()
        return cur.rowcount
