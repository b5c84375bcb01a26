"""Process-group setup for a mesh of ranks (the serving front door).

Counterpart of ``repro.configs.devices``. In torch a "device" of a mesh
is a rank: one process per position, each holding its shards. A rank
calls :func:`setup_devices` before it builds a mesh:

    from repro_torch.configs import setup_devices
    setup_devices(platform="cpu", n_devices=2)

which joins the process group named by ``RANK`` and ``WORLD_SIZE`` through
a file rendezvous (``REPRO_RENDEZVOUS_FILE``: no TCP port is chosen), on
NCCL for ``"cuda"`` and gloo for ``"cpu"``. The call is idempotent for the
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
#: seconds :func:`spawn_ranks` waits for each rank's result and exit
RANK_TIMEOUT_S = 240.0


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
    if not path:
        raise RuntimeError(f"{RENDEZVOUS_ENV} names no rendezvous file")
    dist.init_process_group(_BACKENDS[platform], init_method=f"file://{path}",
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
                args: Sequence[Any] = (), *, rendezvous_dir: str | None = None
                ) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``n`` spawned local ranks, each joined to
    one process group by :func:`setup_devices`, and return their results
    by rank. ``fn`` must be importable by name (a module-level function);
    its result must pickle. A rank that raises, or gives no result within
    :data:`RANK_TIMEOUT_S`, fails the call."""
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
            out: dict[int, Any] = {}
            failures = []
            # drain before join: a rank blocks on a full pipe until read
            for _ in range(n):
                rank, ok, value = _get(results, procs)
                if ok:
                    out[rank] = value
                else:
                    failures.append(f"rank {rank}:\n{value}")
            if failures:
                raise RuntimeError("\n".join(failures))
            for p in procs:
                p.join(RANK_TIMEOUT_S)
            return [out[r] for r in range(n)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _get(results, procs):
    """The next rank's result; fails when every rank has exited without
    one or :data:`RANK_TIMEOUT_S` seconds pass."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while time.monotonic() < deadline:
        if not results.empty():
            return results.get()
        if all(not p.is_alive() for p in procs) and results.empty():
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"ranks exited with codes {codes} and no "
                               f"result")
        time.sleep(0.01)
    raise TimeoutError(f"no rank result within {RANK_TIMEOUT_S} s")
