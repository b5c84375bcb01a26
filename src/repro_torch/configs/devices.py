"""Process-group setup for a mesh of ranks (the serving front door).

Counterpart of ``repro.configs.devices``. In torch a "device" of a mesh
is a rank: one process per position, each holding its shards. A rank
calls :func:`setup_devices` before it builds a mesh:

    from repro_torch.configs import setup_devices
    setup_devices(platform="cpu", n_devices=2)

which joins the process group named by ``RANK`` and ``WORLD_SIZE`` through
a file rendezvous (``REPRO_RENDEZVOUS_FILE``: no TCP port is chosen) or,
without one, through ``MASTER_ADDR`` and ``MASTER_PORT`` as ``torchrun``
sets them, on NCCL for ``"cuda"`` and gloo for ``"cpu"``. The call is idempotent for the
same world and fails loudly when the world is not ``n_devices`` ranks.
:func:`spawn_ranks` starts ``n`` local ranks that do so.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

RENDEZVOUS_ENV = "REPRO_RENDEZVOUS_FILE"
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: seconds :func:`spawn_ranks` waits, by default, for the ranks' results,
#: and for each rank's exit after its result
RANK_TIMEOUT_S = 240.0
#: seconds the other ranks get to report once one rank has failed
FAILURE_GRACE_S = 10.0


def setup_devices(platform: str = "cuda", n_devices: int | None = None
                  ) -> list[torch.device]:
    """Join the process group for the calling rank and return the device
    of every rank (index = rank): ``cuda:<rank % cards>`` for ``"cuda"``,
    the CPU for ``"cpu"``, where each rank runs one thread."""
    if platform not in _BACKENDS:
        raise ValueError(f"platform {platform!r}; options {sorted(_BACKENDS)}")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if n_devices is not None and world != int(n_devices):
        raise RuntimeError(
            f"requested {n_devices} {platform} devices but WORLD_SIZE is "
            f"{world}: start one process per device (spawn_ranks) with "
            f"RANK, WORLD_SIZE and {RENDEZVOUS_ENV} set")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda' but no CUDA device is "
                               "available")
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", r % cards) for r in range(world)]
        torch.cuda.set_device(devices[rank])
    else:
        torch.set_num_threads(1)
        devices = [torch.device("cpu")] * world
    if dist.is_initialized():
        if dist.get_world_size() != world or \
                dist.get_backend() != _BACKENDS[platform]:
            raise RuntimeError(
                f"the process group is already {dist.get_backend()} over "
                f"{dist.get_world_size()} ranks, not {_BACKENDS[platform]} "
                f"over {world}")
        return devices
    path = os.environ.get(RENDEZVOUS_ENV)
    if path:
        init_method = f"file://{path}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        raise RuntimeError(f"neither {RENDEZVOUS_ENV} nor MASTER_ADDR names "
                           f"a rendezvous")
    dist.init_process_group(_BACKENDS[platform], init_method=init_method,
                            world_size=world, rank=rank)
    return devices


def mesh_device_type() -> str:
    """The device type of a mesh over this process group's ranks."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_serving_mesh(data: int = 1, model: int = 1,
                      axis_names: Sequence[str] = ("data", "model")
                      ) -> DeviceMesh:
    """(data, model) mesh over the ranks of the process group, for sharded
    serving."""
    return init_device_mesh(mesh_device_type(), (int(data), int(model)),
                            mesh_dim_names=tuple(axis_names))


def _rank_main(rank: int, n: int, platform: str, path: str, fn: Callable,
               args: Sequence[Any], results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      **{RENDEZVOUS_ENV: path})
    try:
        setup_devices(platform, n)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, platform: str = "cpu",
                args: Sequence[Any] = (), *, rendezvous_dir: str | None = None,
                timeout: float | None = RANK_TIMEOUT_S) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``n`` spawned local ranks, each joined to
    one process group by :func:`setup_devices`, and return their results
    by rank. ``fn`` must be importable by name (a module-level function);
    its result must pickle. The call fails when a rank raises or exits
    without a result, or, unless ``timeout`` is None, when the ranks have
    not all returned within ``timeout`` seconds (a training launcher
    passes None: its ranks return when training ends)."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        path = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, platform, path, fn, tuple(args),
                                   results), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            out = _collect(results, procs, timeout)
            for p in procs:
                p.join(RANK_TIMEOUT_S)
            return [out[r] for r in range(n)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _collect(results, procs, timeout: float | None) -> dict[int, Any]:
    """Every rank's result by rank. Raises once every rank has reported
    and one failed, when a rank has exited without a result, or at the
    deadline; after a failure the others get :data:`FAILURE_GRACE_S` to
    report theirs (a rank blocked in a collective with the failed one
    never does)."""
    start = time.monotonic()
    deadline = None if timeout is None else start + timeout
    out: dict[int, Any] = {}
    failures: dict[int, str] = {}
    # drain before join: a rank blocks on a full pipe until read
    while len(out) + len(failures) < len(procs):
        if not results.empty():
            rank, ok, value = results.get()
            if ok:
                out[rank] = value
            else:
                failures[rank] = value
                grace = time.monotonic() + FAILURE_GRACE_S
                deadline = grace if deadline is None else min(deadline,
                                                              grace)
            continue
        lost = [r for r, p in enumerate(procs)
                if not p.is_alive() and r not in out and r not in failures]
        # a rank writes its result before it exits: read the pipe again
        if lost and results.empty():
            for r in lost:
                failures[r] = (f"exited with code {procs[r].exitcode} and "
                               f"no result")
            break
        if deadline is not None and time.monotonic() > deadline:
            if not failures:
                waiting = [r for r in range(len(procs)) if r not in out]
                raise TimeoutError(f"ranks {waiting} gave no result within "
                                   f"{timeout} s")
            break
        time.sleep(0.01)
    if failures:
        raise RuntimeError("\n".join(f"rank {r}:\n{v}" for r, v in
                                     sorted(failures.items())))
    return out
