"""``repro_torch.launch.specs`` against ``src/repro/launch/specs.py``: the
port's meta-device trees have the reference's ``jax.eval_shape`` shapes
and dtypes leaf by leaf, path by path, and hold no storage."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import applicable as r_applicable
from repro.configs import get_config as r_get_config
from repro.launch import specs as r_specs
from repro.train.optimizer import make_optimizer as r_make_optimizer

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import specs
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.tree import tree_paths


def _ref_leaves(tree):
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), tuple(leaf.shape), np.dtype(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _port_leaves(tree):
    out = []
    for path, leaf in tree_paths(tree):
        assert leaf.device.type == "meta", (path, leaf.device)
        out.append((path, tuple(leaf.shape),
                    np.dtype(str(leaf.dtype).replace("torch.", ""))
                    if leaf.dtype != torch.bfloat16 else
                    np.dtype(jax.numpy.bfloat16)))
    return out


def _same(ref_tree, port_tree):
    ref, port = _ref_leaves(ref_tree), _port_leaves(port_tree)
    assert [p for p, _, _ in port] == [p for p, _, _ in ref]
    for r, p in zip(ref, port):
        assert r == p, (r, p)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_and_opt_state_match_reference(arch, opt):
    r_cfg = r_specs.sharded_config(r_get_config(arch))
    cfg = specs.sharded_config(get_config(arch))
    r_params = r_specs.abstract_params(r_cfg)
    params = specs.abstract_params(cfg)
    _same(r_params, params)
    _same(r_specs.abstract_opt_state(r_make_optimizer(opt), r_params),
          specs.abstract_opt_state(make_optimizer(opt), params))


def _decode_cells():
    return [(a, s) for a in list_archs() for s, spec in SHAPES.items()
            if spec.kind == "decode"
            and r_applicable(r_get_config(a), R_SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_abstract_cache_matches_reference(arch, shape):
    """The cache at the decode shapes' batch and length; the port's
    position is a Python int where the reference's is a scalar array."""
    spec = SHAPES[shape]
    r_cache = r_specs.abstract_cache(
        r_specs.sharded_config(r_get_config(arch)), spec.global_batch,
        spec.seq_len)
    cache = specs.abstract_cache(specs.sharded_config(get_config(arch)),
                                 spec.global_batch, spec.seq_len)
    assert cache.pop("pos") == 0 and r_cache.pop("pos").shape == ()
    _same(r_cache, cache)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch):
    r_cfg = r_specs.sharded_config(r_get_config(arch))
    cfg = specs.sharded_config(get_config(arch))
    for name, spec in SHAPES.items():
        for labels in (False, True):
            _same(r_specs.input_specs(r_cfg, R_SHAPES[name], labels),
                  specs.input_specs(cfg, spec, labels))
