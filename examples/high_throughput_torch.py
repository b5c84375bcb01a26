"""High-throughput mode on the PyTorch port: the daemon (broker + worker
pool) chewing through a batch of GPUTrainJobs with injected faults — the
paper's headline deployment (fig. 4/5). The twin of
``examples/high_throughput.py``.

    PYTHONPATH=src python examples/high_throughput_torch.py --jobs 8 --workers 2
    PYTHONPATH=src python examples/high_throughput_torch.py --crash   # kill workers mid-run
    PYTHONPATH=src python examples/high_throughput_torch.py --device cpu

Each job trains the reduced ``qwen2-0.5b`` on ``--device`` (the CUDA card
unless told otherwise; without a card and without ``--device cpu`` every
job ends with exit code 100, whose reason names the missing card).

With --crash, workers hard-exit every ~2s until the supervisor has
restarted four of them; jobs still finish because (a) the broker requeues
un-acked tasks when heartbeats stop, and (b) each process resumes from its
last persisted checkpoint on whichever worker picks it up.

With --cached-rerun, the whole batch is submitted a second time after the
first pass finishes: the daemon workers (which inherit REPRO_CACHING from
this process) resolve every job against the provenance cache, clone the
outputs and never touch the scheduler.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, "src")

from repro_torch.calcjobs import GPUTrainJob
from repro_torch.core import Dict
from repro_torch.engine.daemon import Daemon
from repro_torch.provenance.store import (NodeType, QueryBuilder,
                                          configure_store)

TERMINAL = ("finished", "excepted", "killed")


def submit_batch(daemon, n_jobs, device):
    pks = []
    for i in range(n_jobs):
        # one builder per job: the discoverable launch surface — inputs
        # validate at assignment, before anything touches the queue
        builder = GPUTrainJob.get_builder()
        builder.config = Dict({
            "arch": "qwen2-0.5b", "steps": 3, "batch": 2, "seq": 32,
            "seed": i, "lr": 1e-3, "device": device})
        builder.metadata.label = f"ht-job-{i}"
        pks.append(daemon.submit(builder))
    return pks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--crash", action="store_true")
    ap.add_argument("--cached-rerun", action="store_true",
                    help="resubmit the batch after it finishes; every job "
                         "should be served from the provenance cache")
    ap.add_argument("--device", default="cuda",
                    help="where each job trains (an input of the job)")
    ap.add_argument("--workdir", default="examples_out/daemon_torch")
    args = ap.parse_args()

    if args.cached_rerun:
        # workers inherit the environment at spawn time
        os.environ["REPRO_CACHING"] = "GPUTrainJob"

    daemon = Daemon(args.workdir, workers=args.workers, slots=16,
                    crash_after=2.0 if args.crash else None)
    daemon.start()
    print(f"daemon up: broker {daemon.host}:{daemon.port}, "
          f"{args.workers} workers")

    t0 = time.time()
    pks = submit_batch(daemon, args.jobs, args.device)
    print(f"submitted {args.jobs} GPUTrainJobs on {args.device}: pks={pks}")

    store = configure_store(daemon.store_path)
    restarts = 0
    while True:
        states = {pk: (store.get_node(pk) or {}).get("process_state")
                  for pk in pks}
        done = sum(s in TERMINAL for s in states.values())
        r = daemon.supervise()
        if r:
            restarts += r
            print(f"  [supervisor] restarted {r} dead worker(s)")
            if restarts >= 4:
                daemon.crash_after = None   # let replacements live
        print(f"  {done}/{len(pks)} done "
              f"({time.time()-t0:.0f}s, {restarts} worker restarts)")
        if done == len(pks):
            break
        time.sleep(1.0)

    print("\n== results ==")
    ok = 0
    for pk in pks:
        node = store.get_node(pk)
        ok += node["exit_status"] == 0
        print(f"  pk={pk}: {node['process_state']} "
              f"exit={node['exit_status']}")
    print(f"\n{ok}/{len(pks)} finished ok in {time.time()-t0:.1f}s "
          f"with {restarts} worker crashes survived")
    qb = QueryBuilder(store)
    print(f"provenance: {qb.nodes(NodeType.CALC_JOB).count()} calcjobs, "
          f"{QueryBuilder(store).nodes(NodeType.DATA).count()} data nodes")

    if args.cached_rerun:
        print("\n== cached second pass ==")
        t1 = time.time()
        pks2 = submit_batch(daemon, args.jobs, args.device)
        while True:
            done = sum((store.get_node(pk) or {}).get("process_state")
                       in TERMINAL for pk in pks2)
            daemon.supervise()
            if done == len(pks2):
                break
            time.sleep(0.2)
        t_warm = time.time() - t1
        hits = 0
        for pk in pks2:
            node = store.get_node(pk)
            attrs = json.loads(node.get("attributes") or "{}")
            hits += "cached_from" in attrs
        print(f"{len(pks2)} jobs finished in {t_warm:.1f}s "
              f"(first pass: {time.time()-t0-t_warm:.1f}s); "
              f"{hits}/{len(pks2)} served from cache")

    daemon.stop()


if __name__ == "__main__":
    main()
