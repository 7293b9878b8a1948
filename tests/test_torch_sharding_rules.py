"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, leaf by leaf and path by path, and the reference's own
rule cases run on the port.

Everything is shapes: the reference's trees come from ``jax.eval_shape``,
the port's from the meta device (``repro_torch.launch.specs``), and the
rules run on the production mesh *shapes*, with no process group.
"""
import dataclasses
import math

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as R_SHAPES
from repro.configs import applicable as r_applicable
from repro.configs import get_config as r_get_config
from repro.distributed import sharding as r_sharding
from repro.launch import specs as r_specs
from repro.train.optimizer import make_optimizer as r_make_optimizer

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.distributed.sharding import (PartitionSpec, batch_specs,
                                              cache_specs, param_specs)
from repro_torch.launch import specs
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.tree import tree_paths

#: the reference's production mesh shapes
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
MESH_SIZES = {"data": 16, "model": 16, "pod": 2}


class _FakeMesh:
    """What the reference's rules read of a mesh: its axis names and
    sizes."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _ref_leaves(tree):
    """``(path, spec)`` of a reference spec tree, paths as ``tree_paths``
    names them."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), spec) for path, spec in flat]


def _port_leaves(specs_tree):
    out = []

    def walk(node, prefix):
        if isinstance(node, PartitionSpec):
            out.append((prefix, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, t in enumerate(node):
                walk(t, prefix + (str(i),))
    walk(specs_tree, ())
    return out


def _same_specs(ref_tree, port_tree):
    ref = _ref_leaves(ref_tree)
    port = _port_leaves(port_tree)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, r), (_, s) in zip(ref, port):
        assert tuple(s) == tuple(r), (path, s, r)
    return len(ref)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch, fsdp):
    """Parameters and AdamW's state: every leaf's spec equals the
    reference's."""
    r_cfg = r_specs.sharded_config(r_get_config(arch))
    r_params = r_specs.abstract_params(r_cfg)
    r_opt = r_specs.abstract_opt_state(r_make_optimizer("adamw"), r_params)
    cfg = specs.sharded_config(get_config(arch))
    params = specs.abstract_params(cfg)
    opt = specs.abstract_opt_state(make_optimizer("adamw"), params)
    n = _same_specs(r_sharding.param_specs(r_params, r_cfg, fsdp=fsdp),
                    param_specs(params, cfg, fsdp=fsdp))
    n += _same_specs(r_sharding.param_specs(r_opt, r_cfg, fsdp=fsdp),
                     param_specs(opt, cfg, fsdp=fsdp))
    assert n > 0


def _cells():
    out = []
    for arch in list_archs():
        for name in SHAPES:
            if r_applicable(r_get_config(arch), R_SHAPES[name])[0]:
                for mesh in MESHES:
                    out.append((arch, name, mesh))
    return out


@pytest.mark.parametrize("arch,shape,mesh", _cells())
def test_batch_and_cache_specs_equal_reference(arch, shape, mesh):
    """Every applicable (arch, shape) on both production mesh shapes: the
    batch specs, and for a decode shape the cache specs, equal the
    reference's."""
    r_cfg = r_specs.sharded_config(r_get_config(arch))
    cfg = specs.sharded_config(get_config(arch))
    spec = SHAPES[shape]
    r_mesh = _FakeMesh(MESHES[mesh])
    train = spec.kind == "train"
    _same_specs(
        r_sharding.batch_specs(
            r_specs.input_specs(r_cfg, R_SHAPES[shape], train), r_mesh),
        batch_specs(specs.input_specs(cfg, spec, train), MESHES[mesh]))
    if spec.kind == "decode":
        r_cache = r_specs.abstract_cache(r_cfg, spec.global_batch,
                                         spec.seq_len)
        cache = specs.abstract_cache(cfg, spec.global_batch, spec.seq_len)
        _same_specs(r_sharding.cache_specs(r_cache, r_cfg, r_mesh),
                    cache_specs(cache, cfg, MESHES[mesh]))


def _axis_size(entry):
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(MESH_SIZES[a] for a in entry)
    return MESH_SIZES[entry]


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_divisible(arch):
    """The reference's case on the port: every spec'd dimension of every
    full-config parameter divides the (16, 16) axes."""
    cfg = specs.sharded_config(get_config(arch))
    params = specs.abstract_params(cfg)
    spec_tree = param_specs(params, cfg)
    leaves = list(tree_paths(params))
    port = _port_leaves(spec_tree)
    assert len(leaves) == len(port)
    for (path, leaf), (_, spec) in zip(leaves, port):
        assert len(spec) <= leaf.dim(), (path, spec, leaf.shape)
        for dim, entry in zip(leaf.shape, tuple(spec)):
            assert dim % _axis_size(entry) == 0, (
                f"{arch}: {path} dim {dim} not divisible by {entry} "
                f"(shape {tuple(leaf.shape)}, spec {spec})")


@pytest.mark.parametrize("arch", list_archs())
def test_large_params_are_sharded(arch):
    """The reference's case on the port: nothing above 64 MB (bf16) is
    fully replicated."""
    cfg = specs.sharded_config(get_config(arch))
    params = specs.abstract_params(cfg)
    port = _port_leaves(param_specs(params, cfg))
    for (path, leaf), (_, spec) in zip(tree_paths(params), port):
        nbytes = leaf.numel() * 2
        if nbytes > 64 * 2**20:
            assert any(e is not None for e in spec), (
                f"{arch}: {path} ({nbytes / 2**20:.0f} MB) is replicated")


def test_vocab_padding():
    cfg = specs.sharded_config(get_config("mamba2-370m"))
    assert cfg.padded_vocab % 256 == 0
    assert cfg.padded_vocab >= cfg.vocab_size
    assert get_config("mamba2-370m").padded_vocab == 50_280
    assert dataclasses.replace(cfg, vocab_pad_multiple=1).padded_vocab == \
        50_280


class _MeshNames:
    """What ``spec_placements`` reads of a ``DeviceMesh``."""
    mesh_dim_names = ("pod", "data", "model")


def test_spec_placements():
    """Each named axis shards its dimension on its mesh dimension; a tuple
    of axes shards one dimension over several, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (spec_placements,
                                                  tree_shardings)

    m = _MeshNames()
    tree = tree_shardings(m, {"w": PartitionSpec("data", "model"),
                              "b": [PartitionSpec()]})
    assert tree["w"].placements == (Replicate(), Shard(0), Shard(1))
    assert tree["b"][0].placements == (Replicate(),) * 3
    assert spec_placements(m, PartitionSpec(("pod", "data"), None,
                                            "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_placements(m, PartitionSpec(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert spec_placements(m, PartitionSpec()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        spec_placements(m, PartitionSpec(("data", "pod")))
    with pytest.raises(ValueError):
        spec_placements(m, PartitionSpec("model", "model"))
