"""Checkpoints in the reference's on-disk format.

Counterpart of ``repro.training.checkpoint``: ``<dir>/step_<n>/`` holds
the leaves' ``.npy`` files and a ``manifest.json`` whose ``leaves`` map
each leaf's path (``params/layers/attn/wq``, ``step``) to its shape, dtype
and files. A checkpoint written by either package restores in the other.
A save is published by renaming its ``.tmp`` directory, so a crash never
leaves a half-written latest step.

One process without a mesh writes one file per leaf. On a mesh (the
state's leaves are DTensors) every rank writes the shards it owns into
the same ``.tmp`` directory, ``<leaf>.shard<i>.npy`` with its index in the
whole leaf (``[start, stop]`` or ``null`` per dim, the reference's form);
a shard several ranks hold is written once, by the rank at coordinate 0
on the axes that replicate it, and a leaf every rank holds whole is
written by rank 0 as one file. Each rank then writes its partial
manifest; rank 0 waits for all of them (marker files, with a timeout:
no collective, so a save may run on a thread beside the training step's
collectives), merges them into ``manifest.json`` and publishes.
:func:`restore_checkpoint` reassembles each leaf from its shards and, given
a mesh, places it there, whatever mesh wrote it (elastic restore).

The training state is fp32 and int32; a bf16 leaf has no numpy dtype
without ``ml_dtypes``, which the port does not use, and is refused.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import uuid
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.sharding import local_slices, place_local
from repro_torch.models.common import (is_dtensor, resolve_device,
                                       tree_leaves)

#: a rank's partial manifest in the ``.tmp`` directory of a mesh's save
PARTIAL_MANIFEST = "manifest.rank{}.json"
#: seconds rank 0 waits for every rank's partial manifest
SHARD_TIMEOUT_S = 600.0


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it: a donated
    train step may rewrite a CPU leaf while a thread writes its snapshot
    (a card's leaf is copied by ``.cpu()`` already)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype without "
                            "ml_dtypes; checkpoint fp32 master copies")
        leaf = leaf.detach()
        if leaf.device.type != "cpu":
            return leaf.cpu().numpy()
        return leaf.numpy().copy()
    return np.array(leaf, copy=True)


class _Snapshot(NamedTuple):
    """What one process writes: ``leaves[key] = (shape, dtype, [(file,
    index, array)])``; ``rank``, ``world`` and the save's ``token`` on a
    mesh (``world`` None without one)."""

    leaves: dict[str, tuple[list[int], str, list[tuple]]]
    rank: int = 0
    world: int | None = None
    token: str = ""


def _shard_of(key: str, t) -> tuple[list[int], str, list[tuple]]:
    """This rank's share of the DTensor leaf ``t``: nothing where another
    rank writes the same shard."""
    from torch.distributed.tensor import Partial, Shard

    if t.dtype == torch.bfloat16:
        _to_numpy(t)                      # raises on every rank alike
    mesh, pls = t.device_mesh, tuple(t.placements)
    if any(isinstance(p, Partial) for p in pls):
        raise ValueError(f"{key}: a partial value ({pls}) is no state")
    coord = mesh.get_coordinate()
    shape = list(t.shape)
    dtype = str(torch.empty((), dtype=t.dtype).numpy().dtype)
    if any(coord[m] for m, p in enumerate(pls) if not isinstance(p, Shard)):
        return shape, dtype, []
    safe = key.replace("/", "__")
    index = [None if (s.start, s.stop) == (0, n) else [s.start, s.stop]
             for s, n in zip(local_slices(shape, pls, mesh), shape)]
    arr = _to_numpy(t.to_local())
    if all(i is None for i in index):
        return shape, dtype, [(f"{safe}.npy", None, arr)]
    shard_id = 0
    for m, p in enumerate(pls):
        if isinstance(p, Shard):
            shard_id = shard_id * mesh.size(m) + coord[m]
    return shape, dtype, [(f"{safe}.shard{shard_id}.npy", index, arr)]


def _snapshot(state: Any) -> _Snapshot:
    """The state's host copies that this process writes (taken on the
    calling thread; on a mesh the ranks also agree on the save's token
    here, through the process group)."""
    flat = tree_leaves(state)
    if not any(is_dtensor(v) for _, v in flat):
        leaves = {}
        for key, leaf in flat:
            arr = _to_numpy(leaf)
            leaves[key] = (list(arr.shape), str(arr.dtype),
                           [(f"{key.replace('/', '__')}.npy", None, arr)])
        return _Snapshot(leaves)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    token = [uuid.uuid4().hex]
    if world > 1:
        dist.broadcast_object_list(token, src=0)
    return _Snapshot({key: _shard_of(key, leaf) for key, leaf in flat},
                     rank, world, token[0])


def save_checkpoint(directory: str, step: int, state: Any,
                    *, max_to_keep: int = 3) -> str:
    """Write ``state`` (a nested dict of tensors, arrays or DTensors) to
    ``<directory>/step_<step>/``; returns that path. On a mesh every rank
    calls it, and the step is published once rank 0 returns."""
    return _write(directory, step, _snapshot(state), max_to_keep)


def _write_json(path: str, obj: Any) -> None:
    with open(path + ".part", "w") as fh:
        json.dump(obj, fh)
    os.replace(path + ".part", path)


def _write(directory: str, step: int, snap: _Snapshot,
           max_to_keep: int) -> str:
    ckpt_dir = os.path.join(directory, f"step_{step}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    entries: dict[str, Any] = {}
    for key, (shape, dtype, shards) in snap.leaves.items():
        for fname, _, arr in shards:
            np.save(os.path.join(tmp_dir, fname), arr)
        entries[key] = {"shape": shape, "dtype": dtype,
                        "shards": [{"file": f, "index": i}
                                   for f, i, _ in shards]}
    if snap.world is not None:
        _write_json(os.path.join(tmp_dir, PARTIAL_MANIFEST.format(snap.rank)),
                    {"token": snap.token, "leaves": entries})
        if snap.rank != 0:
            return ckpt_dir
        entries = _merge_partials(tmp_dir, snap.world, snap.token)

    manifest = {"step": step, "time": time.time(), "leaves": entries}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    # atomic publish: a crash mid-save never corrupts the latest checkpoint
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)

    _gc_old(directory, max_to_keep)
    return ckpt_dir


def _merge_partials(tmp_dir: str, world: int, token: str) -> dict[str, Any]:
    """Every rank's partial manifest of this save (``token``), merged in
    rank order and removed; raises when one is missing after
    :data:`SHARD_TIMEOUT_S` or a leaf's shards do not cover it."""
    paths = [os.path.join(tmp_dir, PARTIAL_MANIFEST.format(r))
             for r in range(world)]
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    parts: dict[int, dict] = {}
    while len(parts) < world:
        for r, path in enumerate(paths):
            if r not in parts and os.path.exists(path):
                with open(path) as fh:
                    part = json.load(fh)
                if part["token"] == token:        # else a stale save's
                    parts[r] = part["leaves"]
        if len(parts) < world:
            if time.monotonic() > deadline:
                missing = sorted(set(range(world)) - set(parts))
                raise TimeoutError(f"{tmp_dir}: no partial manifest from "
                                   f"ranks {missing} within "
                                   f"{SHARD_TIMEOUT_S} s")
            time.sleep(0.01)
    merged: dict[str, Any] = {}
    for r in range(world):
        for key, entry in parts[r].items():
            merged.setdefault(key, {"shape": entry["shape"],
                                    "dtype": entry["dtype"], "shards": []})
            merged[key]["shards"] += entry["shards"]
    for key, entry in merged.items():
        shards = entry["shards"]
        covered = sum(math.prod(n if i is None else i[1] - i[0]
                                for i, n in zip(sh["index"], entry["shape"]))
                      if sh["index"] is not None else math.prod(entry["shape"])
                      for sh in shards)
        distinct = len({json.dumps(sh["index"]) for sh in shards})
        if covered != math.prod(entry["shape"]) or distinct != len(shards):
            raise RuntimeError(f"{key}: {len(shards)} shards ({distinct} "
                               f"distinct) cover {covered} of "
                               f"{math.prod(entry['shape'])} elements")
    for path in paths:
        os.remove(path)
    return merged


def _steps(directory: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def _gc_old(directory: str, max_to_keep: int) -> None:
    for s in sorted(_steps(directory))[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _read_leaf(ckpt_dir: str, entry: dict) -> np.ndarray:
    shards = entry["shards"]
    if shards[0]["index"] is None:
        return np.load(os.path.join(ckpt_dir, shards[0]["file"]))
    full = np.zeros(entry["shape"], dtype=entry["dtype"])
    for shard in shards:
        idx = tuple(slice(s[0], s[1]) if s is not None else slice(None)
                    for s in shard["index"])
        full[idx] = np.load(os.path.join(ckpt_dir, shard["file"]))
    return full


def restore_checkpoint(directory: str, step: int | None = None, *,
                       target: Any = None,
                       device: str | torch.device | None = None,
                       mesh=None, placements: Any = None) -> Any:
    """The state saved at ``step`` (the latest when None) as a nested dict
    of tensors on ``device`` (the card when None). ``target``, a nested
    dict (with lists where the state has them: the hybrid's and the
    xLSTM's layers), gives the structure to fill (every one of its leaves
    must be in the checkpoint); without it the manifest's paths give the
    structure, dicts all the way down.
    With ``mesh`` and ``placements`` (a tree of DTensor placements by the
    same paths, :func:`~repro_torch.distributed.sharding.tree_placements`)
    every leaf is a DTensor on ``mesh`` and each rank holds its own slice,
    whatever mesh, or none, wrote the checkpoint."""
    device = resolve_device(device)
    pls = dict(tree_leaves(placements)) if mesh is not None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        manifest = json.load(fh)

    def load(key: str) -> torch.Tensor:
        arr = torch.from_numpy(np.array(
            _read_leaf(ckpt_dir, manifest["leaves"][key]), copy=True))
        if mesh is None:
            return arr.to(device)
        return place_local(arr, pls[key], mesh, device)

    if target is None:
        return _nest({key: load(key) for key in manifest["leaves"]})
    return _fill(target, load)


class AsyncCheckpointer:
    """Overlap checkpoint writes with compute (one in flight at a time):
    the state is copied to host memory at once, then written by a
    background thread; the next save, or :meth:`wait`, joins it. On a
    mesh every rank saves each step, and rank 0's thread publishes once
    every rank's thread has written its shards (no collective runs on a
    thread)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_path: str | None = None
        #: the step of the latest save started
        self.last_step: int | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        snap = _snapshot(state)
        self.last_step = step

        def write():
            try:
                self.last_path = _write(self.directory, step, snap,
                                        self.max_to_keep)
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _fill(target: Any, load, prefix: str = "") -> Any:
    """``target``'s dicts and lists (the hybrid's and the xLSTM's layers)
    with each leaf replaced by ``load(its path)``; a list's index is its
    path element, as :func:`~repro_torch.models.common.tree_leaves` and the
    reference's ``_leaf_key`` write it."""
    if isinstance(target, Mapping):
        return {k: _fill(v, load, f"{prefix}{k}/") for k, v in target.items()}
    if isinstance(target, list):
        return [_fill(v, load, f"{prefix}{i}/") for i, v in enumerate(target)]
    return load(prefix.rstrip("/"))


def _nest(flat: dict[str, Any]) -> dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    root: dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root
