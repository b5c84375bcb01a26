"""Common building blocks shared by every architecture family.

Counterpart of ``repro.models.common``. Parameters are plain nested dicts
of tensors keyed exactly like the reference's pytrees, with the stacked
leading ``layers`` dimension (the hybrid keeps the reference's list of
per-layer dicts instead), so a reference parameter tree maps onto the
port leaf for leaf (see :mod:`repro_torch.models.convert`).

* Parameters are stored in ``param_dtype`` (fp32 master copies) and used
  in ``dtype`` (bf16); :func:`cast_for_compute` does that cast once for
  every weight that the reference casts at each use.
* Entry points take an explicit ``device``. ``None`` means the card:
  :func:`resolve_device` raises when there is none rather than carrying on
  on the CPU.
* Logical sharding: every parameter, cache and activation names its dims
  with *logical* axes (``ParamSpec.axes``, the ``*_axes`` trees, the
  ``shard(x, *axes)`` sites). Under :class:`axis_rules` they resolve to
  mesh axes through :mod:`repro_torch.distributed.sharding`, tensors are
  ``DTensor``s and :func:`shard` redistributes them; without rules
  :func:`shard` is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (local_slices, mesh_sizes,
                                              placements, resolve_spec)

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Without a card and without ``device`` this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the port on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

VOCAB_PAD_MULTIPLE = 256

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def pad_vocab(vocab_size: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    """Pad the embedding table so it divides any reasonable model axis."""
    return int(math.ceil(vocab_size / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single config type covering all assigned architecture families.

    Field for field the reference's ``ModelConfig``; only the dtype
    properties differ (torch dtypes)."""

    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False           # qwen2-style bias on qkv projections
    rope_theta: float = 10_000.0
    use_rope: bool = True
    attn_impl: str = "direct"        # direct | chunked | pallas (= kernel)
    attn_q_block: int = 512          # chunked q tile
    attn_kv_block: int = 512         # chunked kv tile
    attn_softcap: float = 0.0        # grok-style logit soft-capping

    # --- mlp ---------------------------------------------------------------
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp

    # --- scalar multipliers (granite) ---------------------------------------
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # 0 -> default 1/sqrt(head_dim)
    logits_scaling: float = 1.0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25

    # --- hybrid (recurrentgemma / griffin) ----------------------------------
    block_pattern: tuple[str, ...] = ()
    local_window: int = 0
    d_rnn: int = 0
    conv_width: int = 4
    rnn_blocks: int = 16

    # --- xlstm ---------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_conv_width: int = 4
    mlstm_chunk: int = 128

    # --- enc-dec (whisper backbone) ------------------------------------------
    encoder_layers: int = 0
    num_frames: int = 0

    # --- vlm (llava backbone) -------------------------------------------------
    num_patches: int = 0

    # --- numerics / infra -----------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "nothing_saveable"
    unroll_layers: bool = False
    ce_chunk: int = 0
    use_pallas: bool = False
    # decode-attention inner product: 'direct' (einsum over the full cache)
    # or 'pallas' (the hand-written decode kernel, ragged per-row lengths).
    decode_impl: str = "direct"
    kv_cache_dtype: str = "bfloat16"   # 'int8' enables quantised KV cache
    kv_repeat: int = 1
    attn_sharding: str = "heads"
    moe_sharding: str = "expert"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def kv_heads_eff(self) -> int:
        """KV heads after physical repetition for shardability."""
        return self.num_kv_heads * self.kv_repeat

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + logical axes + init for one parameter leaf."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | rglru_lambda
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


ParamTree = Any      # nested dict of tensors
SpecTree = Any       # nested dict of ParamSpec


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nest of dicts and lists, keeping its
    keys and list order."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in the order JAX flattens a tree: dicts by
    sorted key, lists by index (the index is the path element)."""
    if isinstance(tree, Mapping):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return [(prefix.rstrip("/"), tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves(v, f"{prefix}{k}/"))
    return out


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype, no storage (the reference's
    ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def spec_shapes(spec_tree: SpecTree, dtype: torch.dtype) -> Any:
    """:class:`ShapeDtype` tree for a spec tree."""
    return map_tree(lambda s: ShapeDtype(s.shape, dtype), spec_tree)


def spec_axes(spec_tree: SpecTree) -> Any:
    """The logical axes of every leaf of a spec tree."""
    return map_tree(lambda s: s.axes, spec_tree)


def _draw_tree(spec_tree: SpecTree,
               draw: Callable[[ParamSpec], torch.Tensor]) -> ParamTree:
    """``spec_tree`` with every spec replaced by ``draw(spec)``, the leaves
    drawn in sorted-key order (the reference's flattening order)."""
    drawn = {path: draw(s) for path, s in tree_leaves(spec_tree)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, Mapping):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return drawn[prefix.rstrip("/")]

    return rebuild(spec_tree)


def _init_rule(s: ParamSpec) -> tuple[str, float]:
    """The reference's init rule for ``s``, which both draw routes follow:
    its kind ("zeros", "ones", "rglru_lambda" or "normal") and, for a
    normal leaf, its std (``s.scale`` over the square root of the fan-in,
    taken from shape[-2])."""
    if s.init in ("zeros", "ones", "rglru_lambda"):
        return s.init, 0.0
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return "normal", s.scale / math.sqrt(max(1, fan_in))


def _rglru_lambda(r: torch.Tensor) -> torch.Tensor:
    """The RG-LRU's Lambda from uniform draws ``r`` in [0, 1): a^(1/8)'s
    logit with a uniform in [0.9, 0.999)."""
    a2 = (0.9 + 0.099 * r) ** (1.0 / 8.0)
    return torch.log(a2 / (1.0 - a2))


def init_params(generator: torch.Generator, spec_tree: SpecTree,
                dtype: torch.dtype, device: torch.device) -> ParamTree:
    """Materialise a parameter tree by the reference's init rules.

    Values are drawn on the CPU from ``generator`` (a CPU generator) in
    sorted-key order and then moved, so one seed gives the same parameters
    on every device."""

    def draw(s: ParamSpec) -> torch.Tensor:
        kind, std = _init_rule(s)
        if kind == "zeros":
            t = torch.zeros(s.shape, dtype=dtype)
        elif kind == "ones":
            t = torch.ones(s.shape, dtype=dtype)
        elif kind == "rglru_lambda":
            t = _rglru_lambda(torch.rand(s.shape, generator=generator,
                                         dtype=dtype))
        else:
            t = std * torch.randn(s.shape, generator=generator, dtype=dtype)
        return t.to(device)

    return _draw_tree(spec_tree, draw)


def init_params_on_device(generator: torch.Generator, spec_tree: SpecTree,
                          dtype: torch.dtype) -> ParamTree:
    """Materialise a parameter tree by the reference's init rules, each leaf
    drawn in ``dtype`` on ``generator``'s device, in sorted-key order.

    A normal leaf is filled in place (``normal_``), so a bf16 tree on the
    card never has an fp32 or host copy: a full-width model's largest leaf
    is drawn where it lives. The numbers differ from :func:`init_params`'s
    (another generator), the rules do not."""
    device = generator.device

    def draw(s: ParamSpec) -> torch.Tensor:
        kind, std = _init_rule(s)
        if kind == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if kind == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if kind == "rglru_lambda":
            # a small leaf, drawn in fp32: log(a / (1 - a)) near a = 1
            # loses every digit in bf16
            return _rglru_lambda(torch.rand(s.shape, generator=generator,
                                            device=device)).to(dtype)
        return torch.empty(s.shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=generator)

    return _draw_tree(spec_tree, draw)


#: leaves the reference keeps in fp32 at use: norm weights and biases go
#: through ``rms_norm``'s or ``layer_norm``'s fp32 math; the hybrid's
#: RG-LRU gates (``lam``, ``w_a``, ``w_i``, ``b_a``, ``b_i``) and causal
#: conv (``conv_w``, ``conv_b``) are read in fp32; so are the xLSTM's
#: mLSTM gates (``w_i``, ``b_i``, ``w_f``, ``b_f``), group-norm scale, and
#: the sLSTM's recurrent weights (``r_*``, applied to its fp32 state) and
#: gate biases. Every other leaf the reference casts to the activation
#: dtype at each use. The xLSTM's keys occur in no dense or hybrid tree, so
#: one set serves every family; the sLSTM's block-diagonal ``w_i`` and
#: ``w_f``, which share a key with the mLSTM's gates, stay fp32 and are
#: cast at use to the same values.
FP32_LEAVES = frozenset({"ln_attn", "ln_mlp", "ln_final", "q_norm", "k_norm",
                         "ln", "lam", "w_a", "w_i", "b_a", "b_i", "conv_w",
                         "conv_b",
                         # the xLSTM (ssm family)
                         "ln_b", "ln_final_b", "w_f", "b_f", "gn_scale",
                         "r_i", "r_f", "r_z", "r_o", "b_z", "b_o"})


def cast_for_compute(params: ParamTree, dtype: torch.dtype,
                     device: torch.device) -> ParamTree:
    """Move ``params`` to ``device`` and cast the weights the reference
    casts at each use to ``dtype`` once. Same numbers, one cast per load
    instead of one per step."""

    def walk(tree, key=None):
        if isinstance(tree, Mapping):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        t = tree.to(device)
        return t if key in FP32_LEAVES else t.to(dtype)

    return walk(params)


def stacked(spec: ParamSpec, layers: int) -> ParamSpec:
    """Add a leading layer-stack dimension to a spec."""
    return ParamSpec(
        shape=(layers, *spec.shape),
        axes=("layers", *spec.axes),
        init=spec.init,
        scale=spec.scale,
    )


def stack_specs(specs: Mapping[str, Any], layers: int) -> Any:
    return map_tree(lambda s: stacked(s, layers), specs)


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, so in-place writes land in the
    stacked tensors)."""
    return map_tree(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# Logical sharding constraints
# ---------------------------------------------------------------------------

# DTensor's modules are imported where rules are installed or a DTensor
# is met, not with this module: they take a second to import, which every
# process that loads a model (a daemon worker, the CLI) would pay.

class _AxisRulesState:
    """Process-global logical -> mesh axis rules; :func:`shard` is the
    identity while none are installed. Installed rules also turn on
    DTensor's implicit replication, so a plain tensor that every rank
    holds whole (positions, masks, rotary tables) mixes with the sharded
    ones."""

    def __init__(self) -> None:
        self.rules: dict[str, Any] | None = None
        self.mesh = None
        self._replication: contextlib.AbstractContextManager | None = None

    def install(self, mesh, rules) -> None:
        from torch.distributed.tensor.experimental import implicit_replication

        self.clear()
        self.mesh = mesh
        self.rules = dict(rules)
        self._replication = implicit_replication()
        self._replication.__enter__()

    def clear(self) -> None:
        if self._replication is not None:
            self._replication.__exit__(None, None, None)
        self.mesh = None
        self.rules = None
        self._replication = None


_AXIS_RULES = _AxisRulesState()


def install_axis_rules(mesh, rules) -> None:
    _AXIS_RULES.install(mesh, rules)


def clear_axis_rules() -> None:
    _AXIS_RULES.clear()


class axis_rules:
    """Context manager installing logical axis rules for :func:`shard`."""

    def __init__(self, mesh, rules):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        install_axis_rules(self.mesh, self.rules)
        return self

    def __exit__(self, *exc):
        clear_axis_rules()
        return False


def logical_to_spec(axes: Sequence[str | None]) -> tuple:
    """The mesh axes (a ``PartitionSpec``-like tuple, one entry per dim)
    that the active rules give the logical ``axes``."""
    rules = _AXIS_RULES.rules or {}
    return tuple(rules.get(ax) if ax is not None else None for ax in axes)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (imports nothing: a DTensor exists only
    once its module is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``; a plain tensor is one that every
    rank holds whole (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a plain tensor that this rank holds whole (a DTensor is
    gathered; a plain tensor is returned as it is)."""
    return x.full_tensor() if is_dtensor(x) else x


def local_offsets(t) -> list[int]:
    """The index, in the whole tensor, of the first element of this rank's
    shard of ``t`` along each dim (the shards are even: see
    :func:`shard`)."""
    return [s.start for s in local_slices(t.shape, t.placements,
                                          t.device_mesh)]


def _placements_of(x: torch.Tensor, axes: Sequence[str | None]) -> tuple:
    st = _AXIS_RULES
    spec = resolve_spec(x.shape, axes, st.rules, mesh_sizes(st.mesh))
    return placements(spec, st.mesh)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Apply a logical sharding constraint; identity when no rules are
    active. Under rules ``x`` is redistributed to the placements its
    logical axes resolve to (a dim its mesh axes do not divide stays
    replicated, as :func:`~repro_torch.distributed.sharding.resolve_spec`
    notes)."""
    st = _AXIS_RULES
    if st.rules is None or st.mesh is None:
        return x
    return as_dtensor(x, st.mesh).redistribute(st.mesh,
                                                _placements_of(x, axes))


def splits_evenly(n: int, axis: str) -> bool:
    """Whether a dim of size ``n`` under the logical ``axis`` is split by
    the active rules' mesh axes: False where they would split it but do
    not divide ``n`` (the dim then stays replicated, see :func:`shard`),
    True otherwise, and without rules."""
    st = _AXIS_RULES
    if st.rules is None or st.mesh is None or st.rules.get(axis) is None:
        return True
    return resolve_spec((n,), (axis,), st.rules,
                        mesh_sizes(st.mesh))[0] is not None


def on_local_shards(fn: Callable[..., Any], args: Sequence[Any],
                    axes: Sequence[Sequence[str | None] | None],
                    outs: Sequence[tuple[Sequence[int],
                                         Sequence[str | None]]] | None = None
                    ) -> Any:
    """``fn(*args)`` for a function that takes plain tensors only (a
    kernel's wrapper hands ``data_ptr()``s to its library). Without rules,
    ``fn(*args)``. Under rules each tensor ``args[i]`` is first placed by
    its logical axes ``axes[i]`` (``None`` for a non-tensor argument,
    which is passed on as it is), ``fn`` runs on every rank's local
    shards, and its output is a DTensor placed like ``args[0]``; a
    function with several outputs gives ``outs``, each output's (shape,
    logical axes), and gets a tuple of DTensors placed by them. The
    gradient of an input that is replicated on a mesh dim where the
    (first) output is sharded is a partial sum there: each rank's output
    shard contributes its own part (the KV heads that several ranks'
    query heads read, an embedding table that every data group's rows
    index, gate blocks that several ranks' channels read)."""
    st = _AXIS_RULES
    if st.rules is None or st.mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = st.mesh
    args = [a if ax is None else as_dtensor(a, mesh)
            for a, ax in zip(args, axes)]
    ins = tuple(None if ax is None else _placements_of(a, ax)
                for a, ax in zip(args, axes))
    if outs is None:
        out = ins[0]
        # a list: local_map reads a tuple as one placement per output
        out_pls: Any = list(out)
    else:
        sizes = mesh_sizes(mesh)
        placed = [placements(resolve_spec(shape, ax, st.rules, sizes), mesh)
                  for shape, ax in outs]
        out, out_pls = placed[0], tuple(list(p) for p in placed)
    return local_map(fn, out_placements=out_pls, in_placements=ins,
                     in_grad_placements=_grad_placements(ins, out),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _grad_placements(ins: Sequence[tuple | None], out: tuple) -> tuple:
    """Each input's gradient placements under ``local_map`` (inputs placed
    ``ins``, output ``out``): a replicated input's is a partial sum on
    each mesh dim where the output is sharded."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and isinstance(o, Shard)
        else p for p, o in zip(pl, out)) for pl in ins)


def on_rows(fn: Callable[..., torch.Tensor], x: torch.Tensor,
            *weights: torch.Tensor) -> torch.Tensor:
    """``fn(x, *weights)`` for a function of each vector along ``x``'s last
    dim (a norm). Without rules, ``fn(x, *weights)``. Under rules ``fn``
    runs on every rank's local shard of ``x`` as it is placed (its last
    dim whole, a partial sum reduced) with ``weights`` whole (FSDP's
    all-gather), and its output is placed as that shard; the weights'
    gradients are summed over the ranks' rows. Left to DTensor, the
    norm's backward takes a gradient that is a partial sum over ``model``
    (the column-parallel products' input gradient) and may reduce-scatter
    it over the rows, which splits unevenly where ``model`` does not
    divide a data group's rows (3 of 6 on 2 x 2); the reshapes behind it
    then cannot take the uneven shards."""
    st = _AXIS_RULES
    if st.rules is None or st.mesh is None:
        return fn(x, *weights)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = st.mesh
    x = as_dtensor(x, mesh)
    last = x.ndim - 1
    out = tuple(Replicate() if isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim % x.ndim == last) else p
        for p in x.placements)
    ins = (out, *(((Replicate(),) * mesh.ndim,) * len(weights)))
    return local_map(fn, out_placements=list(out), in_placements=ins,
                     in_grad_placements=_grad_placements(ins, out),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, *(as_dtensor(w, mesh) for w in weights))


def _rows(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[ids]


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of an embedding table. Under a mesh the
    table is gathered whole and each rank looks up its own rows of the
    batch (:func:`on_local_shards`; the table's gradient is summed over
    the data groups): DTensor (torch 2.11) has no working rule for the
    row gather's backward (``index_put`` into the table's gradient) with
    the ids sharded over the batch."""
    return on_local_shards(_rows, (ids, table),
                           (("batch", None), (None, None)))


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

@functools.cache
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def mul_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` first rounded to ``x``'s dtype.

    JAX rounds a Python scalar to the array's dtype before it multiplies
    (a weakly typed constant); PyTorch would keep it in fp32 and round only
    the product, which moves a bf16 result by one ulp in a fifth to a third
    of the elements (``x * 0.22``, ``x * 2560 ** 0.5``). Rounding ``c`` on
    the host first gives the reference's numbers and no extra kernel."""
    return x * _rounded(float(c), x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, on each rank's rows under a mesh (:func:`on_rows`)."""
    return on_rows(functools.partial(_rms_norm, eps=eps), x, weight)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
              ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32: the population variance ``mean((x - mu)^2)``,
    ``rsqrt(var + eps)``, weight and bias applied in fp32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


def causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. w: (width, C); b: (C,); x: (B, S,
    C); state: the last ``width - 1`` inputs, (B, width - 1, C). Taps are
    summed in fp32 in the reference's order. Returns (out in x's dtype,
    new state)."""
    width = w.shape[0]
    dt = x.dtype
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(dt)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(width):
        out = out + xp[:, j:j + s].float() * w[j].float()
    out = out + b.float()
    return out.to(dt), xp[:, xp.shape[1] - (width - 1):]


def store_state(state: dict[str, torch.Tensor],
                new: dict[str, torch.Tensor]) -> None:
    """Write a recurrent layer's new state into ``state`` in place."""
    for name, t in new.items():
        state[name].copy_(t)


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings of ``positions`` (...,) in
    fp32, (..., dim): ``[sin | cos]`` of ``position * exp(-log(10000) /
    (dim // 2 - 1) * i)`` for ``i < dim // 2``."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        dim // 2, dtype=torch.float32, device=positions.device))
    scaled = positions.float()[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def sinusoidal_positions(length: int, dim: int,
                         device: torch.device | None = None) -> torch.Tensor:
    """The sinusoids of positions 0 .. length - 1, (length, dim) in fp32."""
    return sinusoid(torch.arange(length, device=device), dim)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float):
    """Rotary embeddings. q: (..., S, H, hd), positions: (..., S)."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    angles = positions[..., :, None].float() * freqs      # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.cat([xr1, xr2], dim=-1).to(x.dtype)

    return rot(q), rot(k)


# The activations of ``jax.nn``. In a half dtype each op rounds to the
# input's dtype and each constant is rounded to it first, as XLA computes
# them; a fused torch activation (``F.silu``, ``torch.sigmoid``,
# ``F.gelu``) rounds once at the end, which moves a bf16 result by one ulp
# in a third to two fifths of the elements. In float32 there is no such
# rounding to mirror: the fused sigmoid, SiLU and tanh-GELU are one launch
# each and agree with XLA's to 1e-6. (The fused exact GELU does not, by
# 1.1e-6 near zero, so it stays op by op.)
_FULL = (torch.float32, torch.float64)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``."""
    if x.dtype in _FULL:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    if x.dtype in _FULL:
        return F.silu(x)
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (``approximate=True``): ``x * ((1 + tanh(sqrt(2
    / pi) * (x + 0.044715 * x**3))) * 0.5)``."""
    if x.dtype in _FULL:
        return F.gelu(x, approximate="tanh")
    inner = x + mul_scalar(x ** 3, 0.044715)
    t = torch.tanh(mul_scalar(inner, math.sqrt(2.0 / math.pi)))
    return x * mul_scalar(1.0 + t, 0.5)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: ``(x * 0.5) * erfc(-x *
    sqrt(1 / 2))``."""
    return mul_scalar(x, 0.5) * torch.erfc(mul_scalar(-x, math.sqrt(0.5)))


_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": silu,
    # the reference's "gelu" is the tanh approximation
    "gelu": gelu_tanh,
    "gelu_exact": gelu_exact,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return _ACTS[name]


# ---------------------------------------------------------------------------
# Remat policy resolution
# ---------------------------------------------------------------------------

#: per policy name, the aten ops whose outputs the backward keeps: ()
#: keeps none (full recompute), None keeps everything (no recompute).
#: ``dots_with_no_batch_dims_saveable`` keeps the matmuls without a batch
#: dimension (``mm``/``addmm``), ``dots_saveable`` the batched ones too.
_SAVED_OPS: dict[str, tuple[str, ...] | None] = {
    "none": (),
    "nothing_saveable": (),
    "dots_saveable": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "everything_saveable": None,
}


def remat_policy(name: str) -> tuple[str, ...] | None:
    """The aten ops whose outputs the named policy saves (see
    ``_SAVED_OPS``); the names are the reference's."""
    if name not in _SAVED_OPS:
        raise ValueError(f"unknown remat policy {name!r}; options "
                         f"{sorted(_SAVED_OPS)}")
    return _SAVED_OPS[name]


def _saving(op_names: tuple[str, ...]) -> Callable[[], Any]:
    """A ``context_fn`` for :func:`checkpoint` that saves the outputs of
    the named aten ops and recomputes the rest."""
    ops = {getattr(torch.ops.aten, n).default for n in op_names}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def maybe_remat(fn: Callable, policy_name: str) -> Callable:
    """``fn`` under activation checkpointing by the named policy (``off``
    and ``everything_saveable``: ``fn`` itself). Remat changes what the
    backward recomputes, never a value."""
    saved = None if policy_name == "off" else remat_policy(policy_name)
    if saved is None:
        return fn
    kw = {"context_fn": _saving(saved)} if saved else {}

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Cross-entropy loss with padded-vocab masking
# ---------------------------------------------------------------------------

def _gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def softmax_cross_entropy(
    logits: torch.Tensor,              # (B, S, Vp) any float dtype
    labels: torch.Tensor,              # (B, S) integer
    mask: torch.Tensor | None,         # (B, S) float/bool, 1 = contributes
    vocab_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked tokens; padded vocab entries are neutralised.
    Returns (loss, denom = max(sum(mask), 1)), both fp32. Under a mesh the
    vocab dim is gathered first, as the serving steps gather it for their
    argmax: DTensor's gather of the gold logit over a sharded vocab leaves
    a partial value it cannot reduce. The gold logit is read on each
    rank's rows (:func:`on_local_shards`): left to DTensor, the read's
    backward fills a zero gradient of the *global* logits' shape on every
    rank before it keeps its rows (at 256 x 4096 rows of 152k logits,
    638 GB per rank)."""
    logits = shard(logits.float(), "batch", "act_seq", None)
    vp = logits.shape[-1]
    if vp != vocab_size:
        pad_bias = torch.where(
            torch.arange(vp, device=logits.device) < vocab_size, 0.0, -1e30)
        logits = logits + pad_bias
    logz = torch.logsumexp(logits, dim=-1)
    gold = on_local_shards(_gold_logit, (logits, labels),
                           (("batch", "act_seq", None), ("batch", "act_seq")))
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    total = (nll * mask).sum()
    denom = torch.clamp_min(mask.sum(), 1.0)
    return total / denom, denom
