"""Checkpoints in the reference's on-disk format.

Counterpart of ``repro.training.checkpoint``: ``<dir>/step_<n>/`` holds
one ``.npy`` per leaf and a ``manifest.json`` whose ``leaves`` map each
leaf's path (``params/layers/attn/wq``, ``step``) to its shape, dtype and
files. A checkpoint written by either package restores in the other. The
port writes one file per leaf (one device, no shards) and reads the
reference's sharded leaves too. A save is published by renaming its
``.tmp`` directory, so a crash never leaves a half-written latest step.

The training state is fp32 and int32; a bf16 leaf has no numpy dtype
without ``ml_dtypes``, which the port does not use, and is refused.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import resolve_device, tree_leaves


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype without "
                            "ml_dtypes; checkpoint fp32 master copies")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, state: Any,
                    *, max_to_keep: int = 3) -> str:
    """Write ``state`` (a nested dict of tensors or arrays) to
    ``<directory>/step_<step>/``; returns that path."""
    ckpt_dir = os.path.join(directory, f"step_{step}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    manifest: dict[str, Any] = {"step": step, "time": time.time(),
                                "leaves": {}}
    for key, leaf in tree_leaves(state):
        arr = _to_numpy(leaf)
        fname = f"{key.replace('/', '__')}.npy"
        np.save(os.path.join(tmp_dir, fname), arr)
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "shards": [{"file": fname, "index": None}]}

    with open(os.path.join(tmp_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    # atomic publish: a crash mid-save never corrupts the latest checkpoint
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)

    _gc_old(directory, max_to_keep)
    return ckpt_dir


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
                       device: str | torch.device | None = None) -> Any:
    """The state saved at ``step`` (the latest when None) as a nested dict
    of tensors on ``device`` (the card when None). ``target``, a nested
    dict, gives the structure to fill (every one of its leaves must be in
    the checkpoint); without it the manifest's paths give the structure."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        manifest = json.load(fh)

    def load(key: str) -> torch.Tensor:
        arr = _read_leaf(ckpt_dir, manifest["leaves"][key])
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    keys = ([k for k, _ in tree_leaves(target)] if target is not None
            else list(manifest["leaves"]))
    return _nest({key: load(key) for key in keys})


class AsyncCheckpointer:
    """Overlap checkpoint writes with compute (one in flight at a time):
    the state is copied to host memory at once, then written by a
    background thread; the next save, or :meth:`wait`, joins it."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_path: str | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        host_state = {k: _to_numpy(v) for k, v in tree_leaves(state)}

        def _write():
            try:
                self.last_path = save_checkpoint(
                    self.directory, step, _nest(host_state),
                    max_to_keep=self.max_to_keep)
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


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
