"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

One command runs one cell once and prints one JSON line::

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells. Everything
that belongs to one configuration, traffic mix, per-layer metric, kernel
kind or work function sits in a file of its own here, found by its name:

* ``configs/<config>.json``: the model as it is run, with its source;
* ``traffic/<traffic>.json``: a mix's parameters, read by the driver the
  file names (``drivers/<driver>.py``);
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``metrics/<metric>.py``: a per-layer metric's reader;
* ``kinds/<kind>.json``: the name patterns of one kind of device kernel;
* ``work/<name>.py``: the operations and bytes of one piece of work;
* ``peaks.json``: the card's published peaks.

``reference/`` is the plain PyTorch reference that ``correct`` is judged
against; it imports nothing of the port. Nothing here imports JAX or the
JAX package.
"""
