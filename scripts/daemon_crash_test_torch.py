"""Crash recovery of the PyTorch port's daemon: the twin of
``scripts/daemon_crash_test.py``.

    PYTHONPATH=src python scripts/daemon_crash_test_torch.py               # the card
    PYTHONPATH=src python scripts/daemon_crash_test_torch.py --device cpu

Four ``GPUTrainJob``s go through a daemon of two workers that hard-exit
(``os._exit(17)``) ``crash_after`` seconds after they connect to the
broker, mid-job; the supervisor restarts them, and after four restarts
the replacements live. Every job must still finish with exit status 0.
Without a card and without ``--device cpu`` every job fails (exit status
100, its reason naming the missing card), and so does the script.
"""

import argparse
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch.calcjobs import GPUTrainJob
from repro_torch.core import Dict
from repro_torch.engine.daemon import Daemon
from repro_torch.provenance.store import configure_store

#: the reference script's job: reduced qwen2-0.5b, 2 steps of 1 x 16
JOB = {"arch": "qwen2-0.5b", "steps": 2, "batch": 1, "seq": 16}
JOBS, WORKERS, SLOTS = 4, 2, 10
#: workers hard-exit (os._exit(17)) this long after connecting — mid-job
CRASH_AFTER_S = 1.5
#: restarts after which replacement workers live
HEAL_AFTER = 4
TERMINAL = ("finished", "excepted", "killed")


def crash_recovery(workdir: str, job: dict, timeout: float = 200.0) -> dict:
    """Run ``JOBS`` copies of ``job`` (seeds 0, 1, ...) through a daemon
    whose workers crash ``CRASH_AFTER_S`` after connecting, until
    ``HEAL_AFTER`` restarts; returns the pks, states, exit statuses,
    restarts, wall, the broker's stats and the store's path."""
    daemon = Daemon(workdir, workers=WORKERS, slots=SLOTS,
                    crash_after=CRASH_AFTER_S)
    daemon.start()
    try:
        pks = [daemon.submit(GPUTrainJob, {"config": Dict(
            {**job, "seed": i})}) for i in range(JOBS)]
        store = configure_store(daemon.store_path)
        t0 = time.time()
        restarts = 0
        states = {}
        while time.time() - t0 < timeout:
            states = {pk: (store.get_node(pk) or {}).get("process_state")
                      for pk in pks}
            if all(s in TERMINAL for s in states.values()):
                break
            r = daemon.supervise()
            if r:
                restarts += r
                # after a few crashes let replacements live
                if restarts >= HEAL_AFTER:
                    daemon.crash_after = None
            time.sleep(0.4)
        wall = time.time() - t0
        stats = daemon._submitter().broker_stats()
    finally:
        daemon.stop()
    return {"pks": pks, "states": states,
            "exit_statuses": {pk: (store.get_node(pk) or {}).get(
                "exit_status") for pk in pks},
            "restarts": restarts, "wall_s": wall, "broker": stats,
            "store_path": daemon.store_path, "broker_db": daemon.broker_db}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the jobs, e.g. cpu (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    job = dict(JOB) if args.device is None else {**JOB,
                                                 "device": args.device}
    out = crash_recovery(tempfile.mkdtemp(prefix="daemon_crash_"), job)
    print("submitted", out["pks"])
    print("restarts:", out["restarts"], "states:", out["states"])
    ok = (all(s == 0 for s in out["exit_statuses"].values())
          and out["restarts"] > 0)
    print("CRASH RECOVERY", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
