"""Dry run: every (arch x shape x mesh x variant) cell on placeholder ranks.

Counterpart of ``repro.launch.dryrun``. Each cell builds the config, its
train state or parameters and cache, and one step's inputs as every
rank's *local* shards, fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage) wrapped as DTensors on the production mesh of a fake
process group (:func:`~repro_torch.configs.devices.setup_fake_devices`,
512 ranks: a single pod uses the first 256), and runs the port's own
step on them once, eagerly. Nothing is compiled: ``trace_s`` (the wall
of that run) takes the place of the reference's ``lower_s`` and
``compile_s``. What rank 0 runs is counted by :class:`StepCounter`,
per rank, and written as one JSON per cell with the reference's keys:

* ``cost_analysis``: ``flops``, the matmul-class FLOPs of every op this
  rank runs (torch's ``flop_registry`` formulas on the local shapes,
  remat recomputation included), and ``bytes accessed``, the input plus
  output bytes of every local op that is not a view or an alias (eager
  runs each op on its own, so that is what it reads and writes);
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, the local bytes of the step's inputs and
  outputs; ``temp_size_in_bytes``, the peak of live local storage made
  during the step (each storage once, views not at all);
  ``alias_size_in_bytes``, the local bytes of the donated argument that
  the outputs alias, as XLA counts the buffers a jitted step's
  ``donate_argnums`` lets it reuse: the train state, which the train step
  updates in place (``make_train_step(..., donate=True)``: the temp then
  holds the gradients and one leaf's update, not a second state), and the
  cache, which prefill and decode write in place; and
  ``generated_code_size_in_bytes`` 0 (nothing is compiled);
* ``collectives``: every collective this rank issues, by kind, with the
  reference's ring model of its wire bytes (:func:`collective_stats`),
  and ``dcn_wire_bytes``, those of groups that span the ``pod`` axis.

DTensor's redistributions issue torch's functional collectives on the
local shards, which the counter reads with their group. On a CPU-type
mesh (a fake group's) DTensor replaces a Shard -> Shard all-to-all with
an all-gather and a chunk; the counter counts it as the one all-to-all
that a card's NCCL mesh issues (:func:`_one_all_to_all`). DTensor's
planning (it runs each op once more on global-shaped fake tensors to
learn its output's shape) is not counted.

Importing this module joins no process group; :func:`main` joins the
512-rank fake group, as the reference's first two lines force 512
placeholder devices:

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --mesh single --variant optimized --out experiments/dryrun

Eager execution counts every layer, so the ``--slope`` cells (L = 2 and
4, which the reference extrapolates from because XLA's cost analysis
counts a scanned body once) are no longer needed; the flag still writes
them under the reference's file names. ``unroll_layers`` changes nothing
here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Any, Iterator

import torch

from repro_torch.configs import ARCH_IDS, get_config, setup_fake_devices
from repro_torch.distributed.sharding import (local_slices, make_rules,
                                              tree_placements)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import (ShapeDtype, axis_rules, is_dtensor,
                                       map_tree, tree_leaves)
from repro_torch.models.registry import SHAPES, build
from repro_torch.serving.serve import make_decode_step, make_prefill_step
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train_step import (TrainConfig, make_train_step,
                                             train_state_axes,
                                             train_state_shapes)

#: ranks of the fake group :func:`main` joins
N_FAKE_RANKS = 512
#: the reference's collective kinds
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: torch's functional collectives (the ops a DTensor redistribution issues
#: on each rank's local tensor) -> the reference's kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
#: ops of those namespaces that move nothing (a wait, a wrapper)
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def ring_wire_bytes(kind: str, s: float, n: int) -> float:
    """Per-rank wire bytes of one collective under the ring model, ``s``
    the op's output bytes on this rank and ``n`` its group size:

    all-gather: S*(n-1)/n   all-reduce: 2*S*(n-1)/n
    reduce-scatter: S_out*(n-1)   all-to-all: S*(n-1)/n   permute: S
    """
    if kind == "all-gather":
        return s * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * s * (n - 1) / n
    if kind == "reduce-scatter":
        return s * (n - 1)
    if kind == "all-to-all":
        return s * (n - 1) / n
    if kind == "collective-permute":
        return float(s)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_stats(records) -> dict:
    """Per-rank wire-byte estimates per collective kind (ring model,
    :func:`ring_wire_bytes`) from ``(kind, output bytes, group size,
    spans pod)`` records; a group of one rank moves nothing."""
    out = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    dcn_bytes = 0.0
    for kind, s, n, cross_pod in records:
        if n <= 1:
            continue
        wire = ring_wire_bytes(kind, s, n)
        out[kind] += wire
        counts[kind] += 1
        if cross_pod:
            dcn_bytes += wire
    return {"wire_bytes": out, "counts": counts,
            "total_wire_bytes": sum(out.values()),
            "dcn_wire_bytes": dcn_bytes}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_ref(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


def _pods(mesh) -> dict[int, int] | None:
    """Global rank -> its coordinate on the mesh's ``pod`` dim (None
    without one)."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return None
    ranks = mesh.mesh.movedim(mesh.mesh_dim_names.index("pod"), 0)
    return {int(r): p for p in range(ranks.shape[0])
            for r in ranks[p].flatten().tolist()}


def _group_ranks(group) -> list[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if isinstance(group, str):
        group = _resolve_process_group(group)
    return dist.get_process_group_ranks(group)


class StepCounter:
    """Counts what this rank runs of a step: FLOPs, bytes accessed, the
    collectives it issues, the peak of live storage made in the step.

    A dispatch mode that sees every op: an op on DTensors is handed on
    (``NotImplemented``) to DTensor, which runs it as ops on the local
    shards with this mode still active, so each op is counted once, on
    the shapes it really runs on, after any redistribution (ops that a
    kernel's wrapper runs under ``on_local_shards`` are local already).
    Enter it with :meth:`counting`."""

    def __init__(self, mesh=None):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, args, kwargs or {})

        self._mode = _Mode()
        self._pod_of = None if mesh is None else _pods(mesh)
        self.flops = 0
        self.bytes_accessed = 0
        self.records: list[tuple[str, int, int, bool]] = []
        self.local_ops = 0
        self.non_fake_tensors = 0
        self.fake = False
        self.peak_bytes = 0
        self._quiet = 0
        self._args: set = set()
        self._live: dict = {}         # StorageWeakRef -> bytes
        self._live_bytes = 0          # >= the live bytes until a sweep

    # -- the counting window --------------------------------------------------
    @contextlib.contextmanager
    def counting(self, args: Any, fake_mode=None) -> Iterator["StepCounter"]:
        """Count what runs inside; ``args`` (a tree of the step's inputs)
        are resident and not counted as made in the step. Under
        ``fake_mode`` every op runs on fake tensors."""
        self._args.update(_storage_ref(t.to_local() if is_dtensor(t) else t)
                          for _, t in _tensor_leaves(args))
        self.fake = fake_mode is not None
        with contextlib.ExitStack() as stack:
            stack.enter_context(self._planning_uncounted())
            if fake_mode is not None:
                stack.enter_context(fake_mode)
                stack.enter_context(_eager_dtensor_caches())
            stack.enter_context(_one_all_to_all(self))
            stack.enter_context(self._mode)
            yield self

    @contextlib.contextmanager
    def _planning_uncounted(self) -> Iterator[None]:
        """DTensor's planning (an op's sharding strategy and output shape,
        which it learns by running the op on global-shaped fake tensors; a
        redistribution's steps and a strided shard's offsets, which it
        reckons with index tensors) runs outside the count and outside any
        fake mode: it is bookkeeping, not the step's work on a rank."""
        import importlib
        import inspect

        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def mod(name):
            return importlib.import_module(f"torch.distributed.tensor.{name}")

        owners = [
            (mod("_sharding_prop").ShardingPropagator,
             ("propagate_op_sharding_non_cached",
              "_propagate_tensor_meta_non_cached")),
            (mod("_redistribute"), ("_gen_transform_infos_non_cached",)),
            (getattr(mod("placement_types"), "_StridedShard", None),
             ("local_shard_size_and_offset",))]
        saved = [(o, n, inspect.getattr_static(o, n)) for o, names in owners
                 for n in names if o is not None and hasattr(o, n)]

        def off_the_books(fn):
            def run(*a, **kw):
                with self.quiet(), unset_fake_temporarily():
                    return fn(*a, **kw)
            return run

        for owner, name, raw in saved:
            setattr(owner, name,
                    staticmethod(off_the_books(raw.__func__))
                    if isinstance(raw, staticmethod) else off_the_books(raw))
        try:
            yield
        finally:
            for owner, name, raw in saved:
                setattr(owner, name, raw)

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """Ops inside are run, not counted."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- per op ------------------------------------------------------------
    def _dispatch(self, func, args, kwargs):
        from torch.utils._pytree import tree_leaves as leaves

        flat = leaves((args, kwargs))
        if any(is_dtensor(a) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._quiet and func.namespace != "prim":
            self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat, out) -> None:
        from torch.utils._pytree import tree_leaves as leaves
        from torch.utils.flop_counter import flop_registry

        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        self.local_ops += 1
        if self.fake and func is not torch.ops.aten.lift_fresh.default:
            # (lift_fresh makes a fake tensor of a constant just built)
            from torch._subclasses.fake_tensor import FakeTensor

            self.non_fake_tensors += sum(not isinstance(t, FakeTensor)
                                         for t in ins + outs)
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name in _NOT_COLLECTIVES:
                self.track(outs)
                return
            if name not in _COLLECTIVE_OPS:
                raise NotImplementedError(f"no kind for collective {func}")
            group = [a for a in flat if isinstance(a, str)][-1]
            self.record(_COLLECTIVE_OPS[name], sum(map(_nbytes, outs)),
                        _group_ranks(group))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        in_refs = {_storage_ref(t) for t in ins}
        aliases = (not func._schema.is_mutable and
                   all(_storage_ref(t) in in_refs for t in outs))
        if not aliases:
            self.bytes_accessed += (sum(map(_nbytes, ins))
                                    + sum(map(_nbytes, outs)))
        self.track(outs)

    def record(self, kind: str, out_bytes: int, ranks: list[int]) -> None:
        """One collective of ``kind`` over global ``ranks`` that leaves
        ``out_bytes`` on this rank."""
        pods = (set() if self._pod_of is None
                else {self._pod_of.get(r) for r in ranks})
        self.records.append((kind, int(out_bytes), len(ranks),
                             len(pods) > 1))

    # -- live storage --------------------------------------------------------
    def track(self, outs) -> None:
        """Storages first seen in ``outs`` are made in the step."""
        for t in outs:
            ref = _storage_ref(t)
            if ref in self._args or ref in self._live:
                continue
            nbytes = t.untyped_storage().nbytes()
            self._live[ref] = nbytes
            self._live_bytes += nbytes
            if self._live_bytes > self.peak_bytes:
                self._sweep()
                self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def _sweep(self) -> None:
        """Forget storages that no tensor holds any more (a new peak is
        only possible while the sum of those still held exceeds it, so
        this runs only then)."""
        dead = [r for r in self._live if r.expired()]
        for r in dead:
            self._live_bytes -= self._live.pop(r)

    def collectives(self) -> dict:
        return collective_stats(self.records)


@contextlib.contextmanager
def _one_all_to_all(counter: StepCounter) -> Iterator[None]:
    """DTensor's Shard -> Shard redistribution counted as the one
    all-to-all that NCCL issues: on a CPU-type mesh DTensor gathers the
    whole dim and keeps a chunk instead (``shard_dim_alltoall``), which
    a card's mesh never does. Its ops run uncounted; its output is one
    all-to-all's over that mesh dim's group."""
    from torch.distributed.tensor import placement_types

    inner = placement_types.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        with counter.quiet():
            out = inner(input, gather_dim, shard_dim, mesh, mesh_dim)
        counter.record("all-to-all", _nbytes(out),
                       _group_ranks(mesh.get_group(mesh_dim)))
        counter.bytes_accessed += _nbytes(input) + _nbytes(out)
        counter.track([out])
        return out

    placement_types.shard_dim_alltoall = counted
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = inner


@contextlib.contextmanager
def _eager_dtensor_caches() -> Iterator[None]:
    """DTensor and torch's functional collectives run as in eager mode
    under a fake mode. They take an active fake mode for graph tracing
    and then search every op's sharding strategy anew (seconds per op on
    a 3-D mesh) and plan redistributions on the way traced graphs need;
    the dry run traces no graph, it runs the step eagerly on fake
    tensors, where the eager caches and paths hold."""
    import sys

    from torch.distributed import _functional_collectives as funcol

    tracing = funcol._are_we_tracing
    # every module of torch.distributed that imported it by name
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed")
            and getattr(m, "_are_we_tracing", None) is tracing]
    for m in mods:
        m._are_we_tracing = lambda: False
    try:
        yield
    finally:
        for m in mods:
            m._are_we_tracing = tracing


def _tensor_leaves(tree: Any) -> list[tuple[str, torch.Tensor]]:
    """The tensor leaves of a nest of dicts, lists and tuples."""
    if isinstance(tree, tuple) and not isinstance(tree, ShapeDtype):
        tree = list(tree)
    return [(k, t) for k, t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def local_bytes(tree: Any) -> int:
    """This rank's bytes of every tensor leaf (a DTensor's local shard)."""
    return sum(_nbytes(t.to_local() if is_dtensor(t) else t)
               for _, t in _tensor_leaves(tree))


#: the argument each kind of step donates (the reference's
#: ``donate_argnums``): the train state, or the cache
DONATED_ARG = {"train": 0, "prefill": 2, "decode": 1}


def aliased_bytes(donated: Any, out: Any) -> int:
    """This rank's bytes of the leaves of ``donated`` whose storage a leaf
    of ``out`` holds (each storage once)."""
    def local(t):
        return t.to_local() if is_dtensor(t) else t

    held = {_storage_ref(local(t)) for _, t in _tensor_leaves(out)}
    seen, total = set(), 0
    for _, t in _tensor_leaves(donated):
        ref = _storage_ref(local(t))
        if ref in held and ref not in seen:
            seen.add(ref)
            total += _nbytes(local(t))
    return total


def trace_step(step, args: tuple, mesh=None, fake_mode=None):
    """``step(*args)`` under a :class:`StepCounter`: (its outputs, the
    counter). With ``fake_mode`` the args are fake local shards (the dry
    run); without, the step runs for real (the same count of a real
    step)."""
    counter = StepCounter(mesh)
    with counter.counting(args, fake_mode):
        out = step(*args)
    return out, counter


# ---------------------------------------------------------------------------
# Variants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Variant:
    """Sharding/numerics knobs explored by the §Perf hillclimb."""

    name: str = "baseline"
    fsdp: bool = False               # paper-naive baseline: pure DP + TP
    fsdp_over_pod: bool = False
    act_seq_shard: bool = False
    microbatches: int = 1
    remat_policy: str = "nothing_saveable"
    kv_cache_dtype: str = "bfloat16"
    attn_impl: str = ""              # '' = config default
    param_dtype: str = "float32"
    optimizer: str = "adamw"
    parallelism: str = "tp"          # tp | zero3 | serve2d
    ce_chunk: int = 0                # chunked cross-entropy (0 = off)
    moe_capacity_factor: float = 0.0  # 0 = config default


BASELINE = Variant()
OPTIMIZED = Variant(name="optimized", fsdp=True, act_seq_shard=False,
                    remat_policy="dots_with_no_batch_dims_saveable")

VARIANTS = {
    "baseline": BASELINE,
    "optimized": OPTIMIZED,
    # ZeRO-3: both in-pod axes are data parallel; params fully sharded and
    # all-gathered per layer
    "zero3": Variant(name="zero3", parallelism="zero3",
                     remat_policy="dots_with_no_batch_dims_saveable"),
    # + Adafactor (factored second moment) for the 314B-class footprint
    "zero3_af": Variant(name="zero3_af", parallelism="zero3",
                        remat_policy="dots_with_no_batch_dims_saveable",
                        optimizer="adafactor"),
    # ZeRO-3 with full remat (trades compute for activation memory)
    "zero3_full_remat": Variant(name="zero3_full_remat", parallelism="zero3",
                                remat_policy="nothing_saveable"),
    # + chunked cross-entropy: never materialize (B, S, vocab) fp32 logits
    "zero3_ce": Variant(name="zero3_ce", parallelism="zero3",
                        remat_policy="nothing_saveable", ce_chunk=512),
    # ZeRO-3 with bf16 parameter storage: all-gathers move half the bytes
    "zero3_bf16": Variant(name="zero3_bf16", parallelism="zero3",
                          remat_policy="dots_with_no_batch_dims_saveable",
                          param_dtype="bfloat16"),
    # ZeRO-3 + 4-way microbatch accumulation
    "zero3_mb4": Variant(name="zero3_mb4", parallelism="zero3",
                         remat_policy="dots_with_no_batch_dims_saveable",
                         microbatches=4),
    # MoE: capacity factor 1.0
    "tp_cf1": Variant(name="tp_cf1", moe_capacity_factor=1.0,
                      remat_policy="dots_with_no_batch_dims_saveable"),
    # serving: bf16 weights + int8 KV cache, TP sharding
    "serve_opt": Variant(name="serve_opt", param_dtype="bfloat16",
                         kv_cache_dtype="int8"),
    # serving: additionally 2D-shard the weights (embed dim over 'data')
    "serve_opt_2d": Variant(name="serve_opt_2d", param_dtype="bfloat16",
                            kv_cache_dtype="int8", fsdp=True),
    # serving: 2D-stationary weights + replicated (tiny) decode activations
    "serve_act": Variant(name="serve_act", param_dtype="bfloat16",
                         kv_cache_dtype="int8", parallelism="serve2d"),
}


def _apply_variant(cfg, var: Variant):
    kw = dict(remat_policy=var.remat_policy, kv_cache_dtype=var.kv_cache_dtype,
              param_dtype=var.param_dtype, use_pallas=False,
              ce_chunk=var.ce_chunk)
    if var.attn_impl:
        kw["attn_impl"] = var.attn_impl
    if var.moe_capacity_factor:
        kw["moe_capacity_factor"] = var.moe_capacity_factor
    return cfg.replace(**kw)


def total_param_count(bundle) -> int:
    return sum(math.prod(s.shape) for _, s in
               tree_leaves(bundle.param_shapes()))


def active_param_count(bundle) -> int:
    """MoE: experts contribute k/E of their parameters per token."""
    cfg = bundle.cfg
    if cfg.family != "moe":
        return total_param_count(bundle)
    total = 0
    for path, leaf in tree_leaves(bundle.param_shapes()):
        n = math.prod(leaf.shape)
        if "moe" in path and ("w_gate" in path or "w_up" in path or
                              "w_down" in path):
            n = n * cfg.num_experts_per_tok // cfg.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _contiguous_strides(shape) -> tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _placed(shapes: Any, pls: Any, mesh, make_local) -> Any:
    """Tensors of the global ``shapes`` (a tree of :class:`ShapeDtype`):
    with a mesh, DTensors placed by ``pls`` whose local tensors are this
    rank's shards, ``make_local(shape, dtype)``; no global tensor is ever
    built (``distribute_tensor`` would scatter it). Without a mesh, the
    whole tensors."""
    from torch.distributed.tensor import DTensor

    if mesh is None:
        return map_tree(lambda s: make_local(tuple(s.shape), s.dtype), shapes)
    if isinstance(shapes, dict):
        return {k: _placed(shapes[k], pls[k], mesh, make_local)
                for k in shapes}
    if isinstance(shapes, list):
        return [_placed(s, p, mesh, make_local) for s, p in zip(shapes, pls)]
    local = [s.stop - s.start for s in local_slices(shapes.shape, pls, mesh)]
    return DTensor.from_local(make_local(tuple(local), shapes.dtype), mesh,
                              pls, run_check=False,
                              shape=torch.Size(shapes.shape),
                              stride=_contiguous_strides(shapes.shape))


def cell_inputs(bundle, cell, var: Variant, mesh, rules, make_local,
                notes: list[str] | None = None):
    """(step, its args) of ``cell``: the train step on the train state and
    a batch, or the prefill step on parameters, a batch and a cache, or
    the decode step on parameters, a cache, tokens (B, 1) and a position.
    On a mesh every tensor is a DTensor of local shards made by
    ``make_local(shape, dtype)``, the position a plain scalar that every
    rank holds; without one (``mesh`` None) every tensor is whole."""

    def placed(shapes, axes):
        pls = (None if mesh is None else
               tree_placements(shapes, axes, rules, mesh, notes))
        return _placed(shapes, pls, mesh, make_local)

    if cell.kind == "train":
        tcfg = TrainConfig(microbatches=var.microbatches,
                           optim=OptimConfig(name=var.optimizer))
        shapes = train_state_shapes(bundle, tcfg)
        axes = train_state_axes(bundle, tcfg)
        state = placed(shapes, axes)
        batch = placed(bundle.batch_struct(cell), bundle.batch_axes("train"))
        step = make_train_step(bundle, tcfg, None if mesh is None else
                               tree_placements(shapes, axes, rules, mesh),
                               donate=True)
        return step, (state, batch)
    params = placed(bundle.param_shapes(), bundle.param_axes())
    cache_shapes = map_tree(lambda t: ShapeDtype(tuple(t.shape), t.dtype),
                            bundle.init_cache(cell.global_batch, cell.seq_len,
                                              "meta"))
    cache = placed(cache_shapes, bundle.cache_axes())
    batch = placed(bundle.batch_struct(cell), bundle.batch_axes(cell.kind))
    if cell.kind == "prefill":
        return make_prefill_step(bundle), (params, batch, cache)
    pos = make_local((), torch.int32)
    return make_decode_step(bundle), (params, cache, batch["tokens"], pos)


def cell_stats(bundle, cell, var: Variant, mesh, rules=None, *,
               device: str | torch.device | None = None,
               notes: list[str] | None = None) -> dict:
    """One step of ``cell`` counted by :class:`StepCounter`: its wall
    (``trace_s``), ``cost_analysis``, ``memory_analysis``, ``collectives``
    and ``local_ops`` (how many ops it ran, how many tensors it met that
    were not fake). Without ``device`` the step runs on fake local shards
    on ``mesh``'s device type (the dry run); with one it runs for real on
    zeros there, on ``mesh`` under ``rules`` or, with no mesh, on whole
    tensors: the same count of a real step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = None
    if device is None:
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        dev = torch.device(mesh.device_type)

        def make_local(shape, dtype):
            with fake_mode:
                return torch.empty(shape, dtype=dtype, device=dev)
    else:
        def make_local(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

    step, args = cell_inputs(bundle, cell, var, mesh, rules, make_local,
                             notes)
    rules_ctx = (contextlib.nullcontext() if mesh is None
                 else axis_rules(mesh, rules))
    t0 = time.time()
    with rules_ctx:
        out, counter = trace_step(step, args, mesh, fake_mode)
    t_trace = time.time() - t0
    return {
        "trace_s": round(t_trace, 2),
        "cost_analysis": {"flops": float(counter.flops),
                          "bytes accessed": float(counter.bytes_accessed)},
        "memory_analysis": {
            "argument_size_in_bytes": local_bytes(args),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": counter.peak_bytes,
            "alias_size_in_bytes": aliased_bytes(
                args[DONATED_ARG[cell.kind]], out),
            "generated_code_size_in_bytes": 0,
        },
        "collectives": counter.collectives(),
        "local_ops": {"count": counter.local_ops,
                      "non_fake_tensors": counter.non_fake_tensors},
    }


def variant_config(arch: str, var: Variant, layers: int | None = None):
    """``arch``'s config under ``var``, ``layers`` deep when given."""
    cfg = _apply_variant(get_config(arch), var)
    if layers is not None:
        kw = {"num_layers": layers, "unroll_layers": True}
        if cfg.encoder_layers:
            kw["encoder_layers"] = layers
        cfg = cfg.replace(**kw)
    return cfg


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               var: Variant = BASELINE, layers: int | None = None):
    """Trace one (arch x shape x mesh) cell on fake local shards. Returns
    its stats dict (the reference's keys; ``trace_s`` in place of
    ``lower_s`` and ``compile_s``).

    ``layers`` overrides the depth (the reference's slope cells)."""
    bundle = build(variant_config(arch, var, layers))
    cfg = bundle.cfg
    cell = SHAPES[shape_name]
    ok, reason = bundle.supports_cell(cell)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "variant": var.name, "skipped": True, "reason": reason}

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(cfg, mesh, fsdp=var.fsdp,
                       fsdp_over_pod=var.fsdp_over_pod,
                       act_seq_shard=var.act_seq_shard,
                       parallelism=var.parallelism)
    notes: list[str] = []
    stats = cell_stats(bundle, cell, var, mesh, rules, notes=notes)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "variant": var.name if layers is None else f"{var.name}_L{layers}",
        "layers_override": layers,
        "variant_detail": dataclasses.asdict(var),
        "skipped": False,
        "n_devices": mesh.size(),
        "params_total": total_param_count(bundle),
        "params_active": active_param_count(bundle),
        "tokens_per_step": (cell.global_batch * cell.seq_len
                            if cell.kind != "decode" else cell.global_batch),
        "kind": cell.kind,
        **stats,
        "sharding_notes": notes[:40],
    }


def cell_filename(arch, shape, mesh, variant):
    return f"{arch}__{shape}__{mesh}__{variant}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--slope", action="store_true",
                    help="also trace L=2/L=4 cells (the reference's "
                         "collective-bytes extrapolation; eager tracing "
                         "counts every layer, so they are not needed)")
    args = ap.parse_args(argv)

    setup_fake_devices(N_FAKE_RANKS)

    archs = [a for a in ARCH_IDS if a != "aiida-demo-110m"] \
        if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    var = VARIANTS[args.variant]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    def slope_layer_counts(arch: str) -> list[int]:
        fam = get_config(arch).family
        return [2, 4] if fam in ("dense", "moe", "vlm", "audio") else []

    jobs: list[tuple[str, str, str, int | None]] = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                jobs.append((arch, shape, mesh_name, None))
                if args.slope:
                    for lc in slope_layer_counts(arch):
                        jobs.append((arch, shape, mesh_name, lc))

    for arch, shape, mesh_name, layers in jobs:
        vname = var.name if layers is None else f"{var.name}_L{layers}"
        fname = outdir / cell_filename(arch, shape, mesh_name, vname)
        if fname.exists() and not args.force:
            print(f"[skip] {fname.name} (cached)")
            continue
        print(f"[cell] {arch} x {shape} x {mesh_name} ({vname}) ...",
              flush=True)
        try:
            res = lower_cell(arch, shape, multi_pod=(mesh_name == "multi"),
                             var=var, layers=layers)
        except Exception:  # noqa: BLE001
            res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "variant": vname, "skipped": False,
                   "error": traceback.format_exc()[-4000:]}
        fname.write_text(json.dumps(res, indent=1))
        status = ("SKIP" if res.get("skipped")
                  else "ERR" if "error" in res else
                  f"ok trace={res.get('trace_s')}s")
        print(f"[done] {fname.name}: {status}", flush=True)


if __name__ == "__main__":
    main()
