"""Lint the PyTorch port's chaos fault-point surface so the three views
stay in sync (the twin of ``scripts/check_fault_points.py``):

1. every name registered in ``repro_torch.chaos.faults.CATALOG`` is
   actually instrumented — a ``fault_point("<name>")`` literal exists in
   src/repro_torch;
2. every ``fault_point(...)`` call site uses a registered name (no drift
   toward unregistered, untestable seams);
3. every fault clause in the built-in scenarios parses and targets at
   least one registered point (``ChaosPlan.parse`` enforces this);
4. every registered name is documented in docs/chaos.md;
5. every built-in scenario is documented in docs/chaos.md.

    python scripts/check_fault_points_torch.py
"""

from __future__ import annotations

import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

_CALL = re.compile(r"""(?:chaos|faults)\.fault_point\(\s*['"]([^'"]+)['"]""")


def main() -> int:
    from repro_torch.chaos.faults import CATALOG, ChaosPlan
    from repro_torch.chaos.harness import SCENARIOS

    errors: list[str] = []

    # 1 + 2: catalog <-> instrumented call sites
    called: dict[str, list[str]] = {}
    src = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _dirs, files in os.walk(src):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding="utf-8") as fh:
                for name in _CALL.findall(fh.read()):
                    called.setdefault(name, []).append(
                        os.path.relpath(path, REPO))
    for name in sorted(set(CATALOG) - set(called)):
        errors.append(f"catalog point {name!r} has no fault_point() call "
                      "site in src/repro_torch")
    for name in sorted(set(called) - set(CATALOG)):
        errors.append(f"fault_point({name!r}) in {called[name]} is not "
                      "registered in CATALOG")

    # 3: scenario fault clauses parse and resolve against the catalog
    for sc in SCENARIOS.values():
        if not sc.chaos:
            continue
        try:
            ChaosPlan.parse(f"seed=1;{sc.chaos}")
        except ValueError as exc:
            errors.append(f"scenario {sc.name!r}: bad fault spec: {exc}")

    # 4: the docs cover every point
    docs = os.path.join(REPO, "docs", "chaos.md")
    if not os.path.exists(docs):
        errors.append("docs/chaos.md does not exist")
    else:
        with open(docs, encoding="utf-8") as fh:
            text = fh.read()
        for name in sorted(CATALOG):
            if name not in text:
                errors.append(f"catalog point {name!r} is not documented "
                              "in docs/chaos.md")
        # 5: ... and every built-in scenario
        for name in sorted(SCENARIOS):
            if f"`{name}`" not in text:
                errors.append(f"scenario {name!r} is not documented in "
                              "docs/chaos.md")

    if errors:
        print(f"check_fault_points_torch: {len(errors)} problem(s)")
        for err in errors:
            print(f"  - {err}")
        return 1
    print(f"check_fault_points_torch: OK ({len(CATALOG)} points instrumented, "
          f"{len(SCENARIOS)} scenarios, docs in sync)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
