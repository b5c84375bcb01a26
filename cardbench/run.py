"""Run one cell of the port's benchmark once and print its result line.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python -m cardbench.run`` from the repository's root does the same.)
Run from the root of a checkout; kernel builds and compiler caches go to
fixed directories under its ``build/``. Exits with 3 and prints no result
where the cell's cards are not there; see ``cardbench.harness``.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where that cannot
    be read), so that set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()


def environment() -> None:
    """Caches inside the checkout, at fixed paths; the repository's
    ``src`` and root on the import path."""
    here = Path(__file__).resolve().parent
    # run as a script, the interpreter puts this directory first on the
    # path, where its modules would shadow the standard library's
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    build = ROOT / "build" / "cardbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def parse(argv: list[str] | None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    environment()
    from cardbench import harness

    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
