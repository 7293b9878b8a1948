"""``repro_torch.models.pspec`` and the hand kernels' wrappers on a mesh.

``constrain`` is the identity outside a mesh (so no unsharded result of the
port changes) and lays a DTensor out by the reference's logical names on a
2-rank gloo mesh, its gradient too.  On a (2, 2) mesh the flash-attention
and MoE wrappers take DTensors through ``local_map`` and give the plain
call's values and gradients.
"""
import pytest
import torch

from torch_dist_common import (constrain_worker, kernel_wrappers_worker,
                               run_ranks)

from repro_torch.models.pspec import ambient_mesh, constrain, \
    constrain_kv_cache


def test_constrain_is_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4)
    assert ambient_mesh() is None
    assert constrain(x, "dp", None, "model") is x
    assert constrain_kv_cache(x) is x


def test_constrain_on_a_two_rank_mesh(tmp_path):
    out = run_ranks(constrain_worker, 2, str(tmp_path / "out.json"),
                    timeout=180)
    assert out["outside_is_input"] and out["plain_is_input"]
    assert out["ambient_outside"] and out["ambient_inside"]
    # "dp" is the size-1 data axis here, "model" splits the last dim
    assert out["placements"] == ["S(0)", "S(2)"]
    assert out["local_shape"] == [2, 3, 2]
    assert out["values_equal"]
    assert out["odd_placements"] == ["R", "R"]
    assert out["leaf_grad_placements"] == ["R", "R"]
    assert out["grad_equal"]


@pytest.fixture(scope="module")
def wrappers(tmp_path_factory):
    path = tmp_path_factory.mktemp("wrappers") / "out.json"
    return run_ranks(kernel_wrappers_worker, 4, str(path), timeout=240)


@pytest.mark.parametrize("heads", ["4_2", "4_1", "6_3", "4_4"])
def test_flash_attention_on_a_mesh_matches_plain_call(wrappers, heads):
    """Batch over "data", query heads over "model" where they divide
    (6 heads over 2: 3 a rank, GQA groups of 2 that straddle ranks).
    Errors relative to the plain call's largest magnitude."""
    r = wrappers[f"attn_{heads}"]
    assert r["err"] < 1e-5 and r["grad_err"] < 1e-5, r
    assert r["placements"] == ["S(0)", "S(2)"]


def test_moe_layer_on_a_mesh_matches_plain_call(wrappers):
    """Tokens over "data", experts over "model": the output, and the
    gradients of the tokens, routing weights and expert weights."""
    r = wrappers["moe_layer"]
    assert r["err"] < 1e-5 and r["grad_err"] < 1e-5, r


def test_single_moe_ops_on_a_mesh_match_plain_calls(wrappers):
    r = wrappers["single_ops"]
    assert r["expert_slots"]
    assert r["dispatch"] == 0.0 and r["combine_slots"] == 0.0, r
