"""Run one of the port's chaos scenarios several times and print, for each
run, whether it passed, its worker restarts, its requeues (the broker's
``tasks_delivered`` - ``tasks_enqueued``: tasks handed out again after a
kill) and its elapsed time: how reliably the scenario's faults land on
workers that hold work.

    PYTHONPATH=src python scripts/chaos_repeat_torch.py kill9-midstep --runs 5
"""

import argparse
import json
import sys

sys.path.insert(0, "src")


def main() -> int:
    from repro_torch.chaos.harness import SCENARIOS, run_scenario

    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    failed = 0
    for i in range(args.runs):
        result = run_scenario(args.scenario, seed=args.seed)
        stats = result.broker_stats
        failed += not result.ok
        print(json.dumps({
            "run": i, "ok": result.ok, "restarts": result.restarts,
            "requeues": (stats.get("tasks_delivered", 0)
                         - stats.get("tasks_enqueued", 0)),
            "elapsed_s": result.elapsed,
            "connect_wait_s": result.connect_wait,
            "failures": result.failures}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
