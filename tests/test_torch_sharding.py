"""The port's sharding layer against the reference's, without ranks.

``make_rules``, ``resolve_spec``, ``tree_partition_specs`` and every
logical-axes tree (parameters, batches, caches) must equal the
reference's for every arch, mesh and strategy; ``placements`` turns a
spec into DTensor placements; ``shard`` is the identity without rules.
The mesh is a stand-in carrying both packages' attributes, so no process
group is needed.
"""

import os
import re

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sh
from repro.models.registry import SHAPES
from repro.models.registry import build as j_build
from repro_torch.configs import ARCH_IDS, get_config, setup_devices
from repro_torch.distributed import sharding as sh
from repro_torch.models import attention, common
from repro_torch.models.registry import build

ROOT = os.path.join(os.path.dirname(__file__), "..")


class FakeMesh:
    """Just enough mesh for rule resolution in both packages: the
    reference's ``axis_names`` + ``devices.shape``, the port's
    ``mesh_dim_names`` + ``shape``."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.devices = np.zeros(shape)
        self.shape = tuple(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# --- twins of tests/test_sharding.py -----------------------------------------

def test_rules_head_tp_arch():
    cfg = get_config("deepseek-67b")
    rules = sh.make_rules(cfg, FakeMesh(*MESHES["16x16"]), fsdp=True)
    assert rules["heads"] == "model"
    assert rules["embed"] == ("data",)
    assert rules["seq_sharded"] is None          # head-TP archs don't seq-shard


def test_rules_seq_parallel_arch():
    cfg = get_config("qwen2-0.5b")
    rules = sh.make_rules(cfg, FakeMesh(*MESHES["16x16"]), fsdp=False)
    assert rules["heads"] is None                 # 14 heads can't shard 16 ways
    assert rules["seq_sharded"] == "model"
    assert rules["embed"] is None                 # fsdp off => replicated


def test_rules_moe_strategies():
    mesh = FakeMesh(*MESHES["16x16"])
    ep = sh.make_rules(get_config("moonshot-v1-16b-a3b"), mesh)
    assert ep["expert_sharded"] == "model" and ep["moe_ffn"] is None
    tp = sh.make_rules(get_config("grok-1-314b"), mesh)
    assert tp["expert_sharded"] is None and tp["moe_ffn"] == "model"


def test_divisibility_fallback_replicates():
    notes = []
    spec = sh.resolve_spec((7, 128), ("batch", "ffn"),
                           {"batch": ("data",), "ffn": "model"},
                           {"data": 16, "model": 16}, notes, "w")
    assert spec == (None, "model")                # 7 % 16 != 0 -> replicated
    assert notes and "7" in notes[0]


def test_multi_pod_batch_axes():
    cfg = get_config("qwen3-4b")
    mesh = FakeMesh(*MESHES["2x16x16"])
    rules = sh.make_rules(cfg, mesh, fsdp=True, fsdp_over_pod=True)
    assert rules["batch"] == ("pod", "data")
    assert rules["embed"] == ("pod", "data")


# --- equal to the reference ----------------------------------------------------

@pytest.mark.parametrize("parallelism", ["tp", "zero3", "serve2d"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_rules_equal_the_reference(arch, parallelism):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape, names in MESHES.values():
        mesh = FakeMesh(shape, names)
        for fsdp in (False, True):
            for over_pod in (False, True):
                for act_seq in (False, True):
                    kw = dict(fsdp=fsdp, fsdp_over_pod=over_pod,
                              act_seq_shard=act_seq, parallelism=parallelism)
                    assert sh.make_rules(cfg, mesh, **kw) == \
                        j_sh.make_rules(jcfg, mesh, **kw), (shape, kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_equal_the_reference(arch):
    bundle, jbundle = build(get_config(arch)), j_build(j_get_config(arch))
    assert bundle.param_axes() == jbundle.param_axes()
    assert bundle.cache_axes() == jbundle.cache_axes()
    for cell in SHAPES.values():
        assert bundle.batch_axes(cell.kind) == jbundle.batch_axes(cell)
    shapes = common.map_tree(lambda s: tuple(s.shape), bundle.param_shapes())
    jshapes = jax_tree_map(lambda s: tuple(s.shape), jbundle.param_shapes())
    assert shapes == jshapes


@pytest.mark.parametrize("arch", ["aiida-demo-110m", "qwen2-0.5b",
                                  "moonshot-v1-16b-a3b", "grok-1-314b"])
def test_partition_specs_equal_the_reference(arch):
    """Every parameter's spec, and the fallback notes, on both meshes."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    bundle, jbundle = build(cfg), j_build(jcfg)
    for shape, names in MESHES.values():
        mesh = FakeMesh(shape, names)
        rules = sh.make_rules(cfg, mesh, fsdp=True)
        notes, jnotes = [], []
        specs = sh.tree_partition_specs(bundle.param_shapes(),
                                        bundle.param_axes(), rules, mesh,
                                        notes)
        jspecs = j_sh.tree_partition_specs(jbundle.param_shapes(),
                                           jbundle.param_axes(), rules, mesh,
                                           jnotes)
        # jax's PartitionSpec reads a one-axis tuple ('data',) as 'data'
        assert common.map_tree(_one_axis, specs) == \
            jax_tree_map(tuple, jspecs, is_spec=True)
        # the port's notes name the leaf, the reference's do not
        assert sorted(n.split(":", 1)[1] for n in notes) == \
            sorted(n.split(":", 1)[1] for n in jnotes)


def test_int8_kv_cache_axes_equal_the_reference():
    from repro.models import attention as j_attn
    for sharding in ("heads", "sequence"):
        cfg = get_config("aiida-demo-110m").replace(
            kv_cache_dtype="int8", attn_sharding=sharding)
        jcfg = j_get_config("aiida-demo-110m").replace(
            kv_cache_dtype="int8", attn_sharding=sharding)
        for layers in (False, True):
            assert attention.kv_cache_axes(cfg, layers=layers) == \
                j_attn.kv_cache_axes(jcfg, layers=layers)


def _one_axis(spec: tuple) -> tuple:
    return tuple(r[0] if isinstance(r, tuple) and len(r) == 1 else r
                 for r in spec)


def jax_tree_map(fn, tree, is_spec=False):
    import jax
    from jax.sharding import PartitionSpec

    leaf = ((lambda x: isinstance(x, PartitionSpec)) if is_spec
            else (lambda x: hasattr(x, "shape")))
    return _lists(jax.tree.map(fn, tree, is_leaf=leaf))


def _lists(tree):
    """A jax pytree of dicts and lists as plain dicts and lists."""
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lists(v) for v in tree]
    return tree


# --- resolve_spec and placements ------------------------------------------------

def test_resolve_spec_keeps_divisible_dims_and_notes_the_rest():
    rules = {"batch": ("pod", "data"), "heads": "model", "embed": None}
    sizes = {"pod": 2, "data": 4, "model": 2}
    notes = []
    assert sh.resolve_spec((16, 6, 64), ("batch", "heads", "embed"), rules,
                           sizes, notes, "q") == (("pod", "data"), "model",
                                                  None)
    assert notes == []
    assert sh.resolve_spec((4, 3, 64), ("batch", "heads", None), rules,
                           sizes, notes, "k") == (None, None, None)
    assert notes == ["k: dim 4 ∤ axes ('pod', 'data') (size 8); replicated "
                     "instead", "k: dim 3 ∤ axes ('model',) (size 2); "
                     "replicated instead"]
    jnotes = []
    j_sh.resolve_spec((4, 3, 64), ("batch", "heads", None), rules, sizes,
                      jnotes, "k")
    assert notes[-2:] == jnotes


@pytest.mark.parametrize("spec,mesh,want", [
    ((None, "model"), ((1, 2), ("data", "model")), (Replicate(), Shard(1))),
    ((("data",), None, "model", None), ((2, 2), ("data", "model")),
     (Shard(0), Shard(2))),
    ((("data",), None, "model", None), ((1, 2), ("data", "model")),
     (Replicate(), Shard(2))),                    # a size-1 axis replicates
    ((("pod", "data"), "model"), ((2, 4, 2), ("pod", "data", "model")),
     (Shard(0), Shard(0), Shard(1))),
    ((("data", "model"), None), ((2, 2), ("data", "model")),
     (Shard(0), Shard(0))),
    ((None, None), ((2, 2), ("data", "model")), (Replicate(), Replicate())),
])
def test_placements_of_a_spec(spec, mesh, want):
    assert sh.placements(spec, FakeMesh(*mesh)) == want


def test_placements_refuse_a_split_against_mesh_order_or_twice():
    mesh = FakeMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="order"):
        sh.placements((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(("model", "model"), mesh)


def test_replicated_is_every_mesh_axis_replicated():
    assert sh.replicated(FakeMesh((2, 2), ("data", "model"))) == \
        (Replicate(), Replicate())


# --- the logical-axis hooks without and with rules ---------------------------------

def test_shard_is_the_identity_without_rules():
    x = torch.ones(2, 3)
    assert common.shard(x, "batch", None) is x
    assert common.logical_to_spec(("batch", "heads")) == (None, None)
    called = []
    out = common.on_local_shards(lambda a, b: called.append(1) or a + b,
                                 (x, 2.0), (("batch", None), None))
    assert called == [1] and torch.equal(out, x + 2.0)


def test_logical_to_spec_follows_installed_rules():
    mesh = FakeMesh((2, 2), ("data", "model"))
    rules = sh.make_rules(get_config("aiida-demo-110m"), mesh, fsdp=False)
    with common.axis_rules(mesh, rules):
        assert common.logical_to_spec(("batch", None, "heads_sharded",
                                       None)) == (("data",), None, "model",
                                                  None)
    assert common.logical_to_spec(("batch",)) == (None,)


def test_setup_devices_fails_loudly_on_another_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="requested 2 cpu devices"):
        setup_devices("cpu", 2)


# --- the port imports neither package ----------------------------------------------

BAD_IMPORT = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                        r"from repro[ .])")


def test_no_port_module_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 90
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if BAD_IMPORT.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: {line}")
    assert bad == []
