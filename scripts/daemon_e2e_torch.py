"""The daemon end to end on the PyTorch port: the twin of
``scripts/daemon_e2e.py``.

    PYTHONPATH=src python scripts/daemon_e2e_torch.py               # the card
    PYTHONPATH=src python scripts/daemon_e2e_torch.py --device cpu

Four ``GPUTrainJob``s (reduced ``qwen2-0.5b``, 2 steps of 1 x 16, seeds
0-3) go through a ``Daemon`` of 2 workers with 10 slots each; every job
must finish with exit status 0 within 150 s. The jobs train on the CUDA
card unless ``--device`` names another device; without a card and
without ``--device`` the script raises before it starts the daemon.
"""

import argparse
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch.calcjobs import GPUTrainJob
from repro_torch.core import Dict
from repro_torch.engine.daemon import Daemon
from repro_torch.models.common import resolve_device
from repro_torch.provenance.store import configure_store

#: the reference script's job: reduced qwen2-0.5b, 2 steps of 1 x 16
JOB = {"arch": "qwen2-0.5b", "steps": 2, "batch": 1, "seq": 16}
JOBS, WORKERS, SLOTS = 4, 2, 10
TIMEOUT_S = 150
TERMINAL = ("finished", "excepted", "killed")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the jobs, e.g. cpu (default: the "
                         "CUDA card)")
    args = ap.parse_args()
    device = str(resolve_device(args.device))
    workdir = tempfile.mkdtemp(prefix="daemon_test_")
    daemon = Daemon(workdir, workers=WORKERS, slots=SLOTS)
    daemon.start()
    print("daemon started on", daemon.host, daemon.port)

    pks = []
    for i in range(JOBS):
        pk = daemon.submit(GPUTrainJob, {"config": Dict({
            **JOB, "seed": i, "device": device})})
        pks.append(pk)
    print("submitted", pks)

    store = configure_store(daemon.store_path)
    t0 = time.time()
    states = {}
    while time.time() - t0 < TIMEOUT_S:
        states = {pk: (store.get_node(pk) or {}).get("process_state")
                  for pk in pks}
        if all(s in TERMINAL for s in states.values()):
            break
        daemon.supervise()
        time.sleep(0.5)
    wall = time.time() - t0
    print("final states:", states)
    for pk in pks:
        n = store.get_node(pk)
        print(pk, n["process_state"], "exit:", n["exit_status"])
    print(f"device: {device}, wall: {wall:.3f} s")
    daemon.stop()
    ok = all((store.get_node(pk) or {}).get("exit_status") == 0 for pk in pks)
    print("DAEMON E2E", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
