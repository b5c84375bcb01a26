"""Two-profile cache sharing on the PyTorch port: export results from
profile A, import into profile B, and relaunch — B reuses A's computed
results without running anything (docs/archive.md walkthrough; the twin
of ``examples/share_cache.py``).

    PYTHONPATH=src python examples/share_cache_torch.py [--out examples_out]

Profile A ("the collaborator who already ran the campaign") executes a
small sweep of deterministic calculations and exports the finished-ok
subgraph as a provenance archive. Profile B (a fresh, empty store —
another machine, another user) imports the archive and submits the *same*
sweep with caching enabled: every process resolves to an imported node,
clones its outputs and records `cached_from` pointing at A's work.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch.caching import enable_caching
from repro_torch.core import ArrayData, Int, Process, ProcessSpec
from repro_torch.engine.launch import run_get_node
from repro_torch.engine.runner import Runner, set_default_runner
from repro_torch.provenance import (
    NodeType, ProvenanceStore, configure_store, export_archive,
    import_archive,
)

OUT_DIR = "examples_out"   # the default of --out


class PowerIterate(Process):
    """A deterministic 'simulation': dominant eigenvalue of a seed-derived
    matrix by power iteration (stand-in for a real calculation)."""

    NODE_TYPE = NodeType.CALC_FUNCTION

    @classmethod
    def define(cls, spec: ProcessSpec) -> None:
        super().define(spec)
        spec.input("seed", valid_type=Int, serializer=Int)
        spec.input("size", valid_type=Int, serializer=Int, default=Int(96))
        spec.input("iters", valid_type=Int, serializer=Int, default=Int(150))
        spec.output("eigenvalue", valid_type=ArrayData)
        spec.output("vector", valid_type=ArrayData)

    async def run(self):
        n = self.inputs["size"].value
        rng = np.random.default_rng(self.inputs["seed"].value)
        mat = rng.standard_normal((n, n))
        mat = mat @ mat.T  # symmetric, real spectrum
        vec = np.ones(n) / np.sqrt(n)
        for _ in range(self.inputs["iters"].value):
            vec = mat @ vec
            vec /= np.linalg.norm(vec)
        self.out("eigenvalue", ArrayData(vec @ mat @ vec))
        self.out("vector", ArrayData(vec))


def run_sweep(seeds: list[int]) -> tuple[list, float]:
    t0 = time.perf_counter()
    nodes = [run_get_node(PowerIterate, seed=s).node for s in seeds]
    return nodes, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the two profiles and the archive")
    out_dir = ap.parse_args().out
    os.makedirs(out_dir, exist_ok=True)
    profile_a = os.path.join(out_dir, "share_a.db")
    profile_b = os.path.join(out_dir, "share_b.db")
    archive = os.path.join(out_dir, "share_results.zip")
    for path in (profile_a, profile_b, archive):
        if os.path.exists(path):
            os.remove(path)
    seeds = list(range(12))

    # --- profile A: compute the sweep, export the results ------------------
    store_a = configure_store(profile_a)
    set_default_runner(Runner(store=store_a))
    nodes_a, t_compute = run_sweep(seeds)
    manifest = export_archive(store_a, archive,
                              [n.pk for n in nodes_a], source=profile_a)
    print(f"[A] computed {len(seeds)} calculations in {t_compute:.2f}s, "
          f"exported {manifest['nodes']} node(s) "
          f"({manifest['payload_files']} array payload(s)) -> {archive}")

    # --- profile B: fresh store, import, relaunch with caching ------------
    store_b = configure_store(profile_b)
    set_default_runner(Runner(store=store_b))
    result = import_archive(store_b, archive)
    print(f"[B] imported {result.nodes_imported} node(s), "
          f"{result.links_imported} link(s)")

    with enable_caching(PowerIterate):
        nodes_b, t_cached = run_sweep(seeds)

    hits = 0
    for node in nodes_b:
        attrs = json.loads(
            (store_b.get_node(node.pk) or {}).get("attributes") or "{}")
        if "cached_from" in attrs:
            src = store_b.get_node(attrs["cached_from_pk"])
            assert src is not None and src["process_state"] == "finished"
            hits += 1
    print(f"[B] relaunched the sweep with caching: {t_cached:.2f}s, "
          f"{hits}/{len(seeds)} cache hits against imported nodes "
          f"({t_compute / max(t_cached, 1e-9):.1f}x faster than computing)")
    if hits != len(seeds):
        sys.exit("expected every relaunch to hit the imported cache")


if __name__ == "__main__":
    main()
