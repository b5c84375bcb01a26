"""Logical-axis -> mesh-axis rules and their placements on a device mesh.

Counterpart of ``repro.distributed.sharding``. The model code annotates
parameters and activations with *logical* axis names; this module maps
them to physical mesh axes for a given mesh and strategy. Key strategy
knobs:

* ``fsdp``          — shard the ``embed`` parameter dim over the in-pod data
                      axis (FSDP). Off = plain data-parallel replication.
* ``fsdp_over_pod`` — additionally shard parameters over the cross-pod axis.
* ``act_seq_shard`` — Megatron-style sequence sharding of the residual
                      stream between blocks.

Every resolved spec is validated against the tensor's shape: a dim that
its assigned mesh axes do not divide evenly falls back to replication for
that dim (recorded in ``notes``). A spec is a tuple with one entry per
tensor dim (the reference's ``PartitionSpec``): ``None``, a mesh axis
name, or a tuple of names. :func:`placements` turns it into DTensor
placements on a :class:`~torch.distributed.device_mesh.DeviceMesh` (one
rank per mesh position), and :func:`distribute_tree` places a whole tree
for serving. For training, :func:`tree_placements` gives a state's
placements from its shapes and axes (the reference's
``tree_named_shardings``), :func:`place_tree` places a tree every rank
holds whole by slicing out each rank's shard (no collective), and
:func:`shard_batch` makes each rank's own batch rows one batch sharded
over the data axes. DTensor's module is imported by the functions that
place tensors, so the rules load without it.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Mapping, Sequence

if TYPE_CHECKING:
    from repro_torch.models.common import ModelConfig

AxisRule = Any   # str | tuple[str, ...] | None


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a device mesh (anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
               fsdp_over_pod: bool = False,
               act_seq_shard: bool = False,
               parallelism: str = "tp") -> dict[str, AxisRule]:
    """parallelism='tp' — model axis does tensor parallelism (baseline);
    parallelism='zero3' — both in-pod axes do data parallelism and every
    parameter is fully sharded on its embed dim (ZeRO-3 / pure-FSDP):
    weights are all-gathered layer-by-layer, activations never cross chips;
    parallelism='serve2d' — decode-optimised: weights stationary 2D
    (embed x data, heads/ffn x model), KV cache batch-sharded over data,
    decode activations replicated over data so the (tiny) token activations
    are re-sharded instead of all-gathering weight shards per step.
    """
    sizes = mesh_sizes(mesh)
    model_size = sizes.get("model", 1)
    has_pod = "pod" in sizes

    if parallelism == "zero3":
        data_axes = (("pod", "data", "model") if has_pod
                     else ("data", "model"))
        shard_axes = ("data", "model")
        none_rules = {k: None for k in (
            "vocab", "heads", "kv_heads_w", "head_dim", "ffn",
            "ffn_sharded_w", "expert", "expert_sharded", "moe_ffn",
            "moe_ffn_act", "rnn_tp", "rnn_blocks", "xlstm_inner",
            "xlstm_hd", "xlstm_hd_out", "vocab_sharded", "heads_sharded",
            "kv_heads_sharded", "seq_sharded", "kv_seq_sharded",
            "ffn_sharded", "rnn_sharded", "xlstm_inner_sharded",
            "xlstm_hd_sharded", "act_seq", "act_seq_rnn")}
        return {
            "batch": data_axes,
            "kv_batch": data_axes,
            "moe_groups": data_axes,
            "layers": None,
            "embed": shard_axes,
            "embed_out": None,
            **none_rules,
        }

    data_axes = (("pod", "data") if has_pod else ("data",))
    if fsdp or parallelism == "serve2d":
        fsdp_axis: AxisRule = (("pod", "data") if (fsdp_over_pod and has_pod)
                               else ("data",))
    else:
        fsdp_axis = None

    heads_tp = cfg.attn_sharding == "heads"
    kv_w_shardable = heads_tp and cfg.num_kv_heads % model_size == 0
    ep = cfg.moe_sharding == "expert"

    serve2d = parallelism == "serve2d"
    rules: dict[str, AxisRule] = {
        # data-parallel dims. serve2d replicates decode activations over
        # data (tokens are tiny) while the KV cache stays batch-sharded.
        "batch": None if serve2d else data_axes,
        "kv_batch": data_axes,
        "moe_groups": None if serve2d else data_axes,
        # parameter dims
        "layers": None,
        "embed": fsdp_axis,
        "embed_out": None,
        "vocab": "model",
        "heads": "model" if heads_tp else None,
        "kv_heads_w": "model" if kv_w_shardable else None,
        "head_dim": None,
        "ffn": "model",
        "ffn_sharded_w": "model",
        "expert": None,                       # TP-in-expert: experts replicated
        "expert_sharded": "model" if ep else None,
        "moe_ffn": None if ep else "model",   # per-expert ffn weight dim
        "moe_ffn_act": None if ep else "model",
        "rnn_tp": "model",
        "rnn_blocks": "model",
        "xlstm_inner": "model",
        "xlstm_hd": None,
        "xlstm_hd_out": None,
        # activation dims
        "vocab_sharded": "model",
        "heads_sharded": "model" if heads_tp else None,
        "kv_heads_sharded": "model" if heads_tp else None,
        "seq_sharded": "model" if not heads_tp else None,
        "kv_seq_sharded": "model" if not heads_tp else None,
        "ffn_sharded": "model",
        "rnn_sharded": "model",
        "xlstm_inner_sharded": None,
        "xlstm_hd_sharded": None,
        "act_seq": "model" if act_seq_shard else None,
        "act_seq_rnn": "model" if act_seq_shard else None,
    }
    return rules


def _axes_to_names(rule: AxisRule) -> tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def resolve_spec(shape: Sequence[int], axes: Sequence[str | None],
                 rules: Mapping[str, AxisRule], sizes: Mapping[str, int],
                 notes: list[str] | None = None, name: str = "") -> tuple:
    """Resolve one tensor's logical axes to a spec, dropping any
    assignment that does not divide the dim evenly."""
    parts: list[AxisRule] = []
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax is not None else None
        names = _axes_to_names(rule)
        if names:
            prod = math.prod(sizes[n] for n in names)
            if dim % prod != 0:
                if notes is not None:
                    notes.append(
                        f"{name}: dim {dim} ∤ axes {names} (size {prod}); "
                        f"replicated instead")
                rule = None
        parts.append(rule if not isinstance(rule, tuple) else tuple(rule))
    return tuple(parts)


def placements(spec: Sequence[AxisRule], mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: ``Shard(dim)`` on each
    mesh dim that the spec assigns to tensor dim ``dim``, ``Replicate()``
    on the others. A dim split over several mesh axes is split in mesh
    order (the reference's major-to-minor order when the spec lists them
    in that order). A mesh dim of size 1 always replicates: a shard of
    the whole tensor is the tensor, and DTensor's view rules refuse to
    merge a dim sharded even over one rank."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out: list = [Replicate()] * len(names)
    taken: set[int] = set()
    for dim, rule in enumerate(spec):
        axes = _axes_to_names(rule)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {tuple(spec)} splits dim {dim} over "
                             f"{axes}, against the mesh's order {names}")
        for m in order:
            if m in taken:
                raise ValueError(f"mesh axis {names[m]!r} assigned twice in "
                                 f"{tuple(spec)}")
            taken.add(m)
            if sizes[names[m]] > 1:
                out[m] = Shard(dim)
    return tuple(out)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, str) or e is None for e in x)


def _map2(fn, a: Any, b: Any, path: str = "") -> Any:
    """``fn(a_leaf, b_leaf, path)`` over two trees of the same dicts and
    lists (the leaves of ``b`` are axes tuples)."""
    if isinstance(a, Mapping):
        return {k: _map2(fn, a[k], b[k], f"{path}{k}/") for k in a}
    if isinstance(a, list):
        if len(a) != len(b):
            raise ValueError(f"{path}: {len(a)} leaves vs {len(b)} axes")
        return [_map2(fn, x, y, f"{path}{i}/")
                for i, (x, y) in enumerate(zip(a, b))]
    if not _is_axes_leaf(b):
        raise ValueError(f"{path}: {b!r} is not a logical-axes tuple")
    return fn(a, b, path.rstrip("/"))


def tree_partition_specs(shapes_tree: Any, axes_tree: Any,
                         rules: Mapping[str, AxisRule], mesh,
                         notes: list[str] | None = None) -> Any:
    """Spec tree from parallel (shapes, logical axes) trees; a shape leaf
    is anything with ``.shape`` or a tuple of ints."""
    sizes = mesh_sizes(mesh)

    def leaf(shape_leaf, axes_leaf, path):
        shp = (shape_leaf.shape if hasattr(shape_leaf, "shape")
               else tuple(shape_leaf))
        return resolve_spec(shp, axes_leaf, rules, sizes, notes, path)

    return _map2(leaf, shapes_tree, axes_tree)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * len(mesh.mesh_dim_names)


def distribute_tree(tree: Any, axes_tree: Any,
                    rules: Mapping[str, AxisRule], mesh,
                    notes: list[str] | None = None) -> Any:
    """A tree of tensors as DTensors on ``mesh``, each placed by its
    logical axes (the reference's ``tree_named_shardings`` plus
    ``device_put``). Every rank passes the same full tensors."""
    from torch.distributed.tensor import distribute_tensor

    sizes = mesh_sizes(mesh)

    def leaf(t, axes, path):
        spec = resolve_spec(t.shape, axes, rules, sizes, notes, path)
        return distribute_tensor(t, mesh, placements(spec, mesh))

    return _map2(leaf, tree, axes_tree)


def tree_placements(shapes_tree: Any, axes_tree: Any,
                    rules: Mapping[str, AxisRule], mesh,
                    notes: list[str] | None = None) -> Any:
    """DTensor placements of every leaf, from parallel (shapes, logical
    axes) trees: the reference's ``tree_named_shardings``. A placements
    leaf is a tuple with one placement per mesh dim."""
    specs = tree_partition_specs(shapes_tree, axes_tree, rules, mesh, notes)
    return _map2(lambda spec, _, path: placements(spec, mesh), specs,
                 axes_tree)


def local_slices(shape: Sequence[int], pls: Sequence, mesh) -> tuple:
    """The slice of each dim of a tensor of ``shape`` that this rank holds
    under placements ``pls`` (even shards, nested in mesh order, as
    :func:`resolve_spec` guarantees and DTensor lays them out)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = []
    for dim, n in enumerate(shape):
        size, off = n, 0
        for m, p in enumerate(pls):
            if isinstance(p, Shard) and p.dim == dim:
                size //= mesh.size(m)
                off += coord[m] * size
        out.append(slice(off, off + size))
    return tuple(out)


def place_local(full, pls: Sequence, mesh, device=None):
    """A tensor that every rank holds whole as a DTensor placed by
    ``pls``: each rank keeps its own slice (moved to ``device`` when
    given), no collective."""
    from torch.distributed.tensor import DTensor

    local = full[local_slices(full.shape, pls, mesh)]
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False)


def place_tree(tree: Any, placements_tree: Any, mesh) -> Any:
    """:func:`place_local` at every leaf of ``tree`` (nested dicts and
    lists of tensors) with the placements at the same path."""
    if isinstance(tree, Mapping):
        return {k: place_tree(tree[k], placements_tree[k], mesh)
                for k in tree}
    if isinstance(tree, list):
        return [place_tree(t, p, mesh) for t, p in zip(tree, placements_tree)]
    return place_local(tree, placements_tree, mesh)


def conform_tree(tree: Any, placements_tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` redistributed to the placements at
    the same path where its own differ (the reference's ``out_shardings``
    of a jitted step)."""
    if isinstance(tree, Mapping):
        return {k: conform_tree(tree[k], placements_tree[k]) for k in tree}
    if isinstance(tree, list):
        return [conform_tree(t, p) for t, p in zip(tree, placements_tree)]
    if tuple(tree.placements) == tuple(placements_tree):
        return tree
    return tree.redistribute(tree.device_mesh, placements_tree)


def batch_coordinate(mesh, rules: Mapping[str, AxisRule]) -> tuple[int, int]:
    """(this rank's index among the data groups, their number): its
    coordinate on the mesh axes that ``rules["batch"]`` names, raveled in
    the rule's order, and the product of their sizes. Ranks that differ
    only on the other axes (``model``) form one data group and read the
    same rows; the reference's ``host_id`` and ``num_hosts``."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_sizes(mesh)
    index, count = 0, 1
    for a in _axes_to_names(rules.get("batch")):
        index = index * sizes[a] + coord[a]
        count *= sizes[a]
    return index, count


def shard_batch(batch: Mapping[str, Any], axes: Mapping[str, Sequence],
                rules: Mapping[str, AxisRule], mesh) -> dict[str, Any]:
    """A batch whose rows are this rank's data group's share as DTensors
    sharded over the data axes by their logical ``axes`` (``batch`` on
    dim 0): the global batch is the data groups' rows concatenated in
    mesh order, and no rank sends a row to another."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)
    _, groups = batch_coordinate(mesh, rules)
    out = {}
    for name, local in batch.items():
        shape = (local.shape[0] * groups, *local.shape[1:])
        pls = placements(resolve_spec(shape, axes[name], rules, sizes), mesh)
        out[name] = DTensor.from_local(local, mesh, pls, run_check=False)
    return out
