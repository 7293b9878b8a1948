"""MoE gradients on the CPU: the port's layer (router, experts, shared
experts and tokens) against ``jax.grad`` of the reference's
``moe_forward``, on the einsum path (``dispatch="einsum"``, which runs
the kernel path's layer body), the sort path and that differentiable
layer body called directly (``ops.moe_dispatch``:
``DispatchSlots``/``CombineSlots`` over the plain versions, what the card
runs over its kernels), with a capacity factor below 1 so that slots are
dropped; and the backward formulas of the two functions against autograd
through their plain versions.  Tolerance 1e-5 of each gradient's largest
magnitude (float32 sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.moe import moe_forward as j_moe_forward  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.train.tree import tree_paths  # noqa: E402

TOL = 1e-5
ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b"]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _kernel_path(params, x_flat, idx, w, cfg, capacity):
    return ops.moe_dispatch(params, x_flat, idx, w, cfg, capacity,
                            moe._expert_ffn)


@pytest.mark.parametrize("path", ["einsum", "sort", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(arch, path, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=0.5)
    params = j_init_moe(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    dispatch = "sort" if path == "sort" else "einsum"

    def loss(p, x):
        y, aux = j_moe_forward(p, x, cfg, dispatch=dispatch)
        return jnp.sum(y * g) + aux

    (gp, gx) = jax.grad(loss, argnums=(0, 1))(params, x)
    if path == "kernel":
        monkeypatch.setattr(moe, "_dispatch_einsum", _kernel_path)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    leaves = dict(tree_paths(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward(tp, tx, cfg, dispatch=dispatch)
    # slots were dropped: some assignment's rank is at or past capacity
    idx, _, _ = moe._route(tp, tx.detach().reshape(-1, cfg.d_model), cfg)
    slot = ops.expert_slots(idx, cfg.num_experts)
    C = moe.capacity_per_expert(idx.shape[0], cfg.num_experts,
                                cfg.experts_per_token, cfg.capacity_factor)
    assert int((slot >= C).sum()) > 0
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    _close(tx.grad.numpy(), np.asarray(gx), "dx")
    want = dict(tree_paths(jax.device_get(gp)))
    assert set(want) == set(leaves)
    for path_, t in leaves.items():
        _close(t.grad.numpy(), np.asarray(want[path_]), "|".join(path_))


@pytest.mark.parametrize("capacity", [3, 40])
def test_slot_functions_backward_matches_autograd_of_plain_versions(
        capacity):
    """``DispatchSlots`` and ``CombineSlots`` against autograd through
    the one-hot oracle and the plain combine: dx, dbuf and dtopk_w, and
    ``combine_weight_grad_ref`` equal to the weight's autograd gradient."""
    rng = np.random.default_rng(7)
    T, k, E, d = 30, 2, 4, 8
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(T)]))
    slot = ops.expert_slots(idx, E)
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    w = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    buf_g = torch.from_numpy(rng.normal(size=(E, capacity, d)).astype(
        np.float32))
    y_g = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))

    xa = x.clone().requires_grad_(True)
    buf = ops.DispatchSlots.apply(xa, idx, slot, E, capacity)
    (buf * buf_g).sum().backward()
    xb = x.clone().requires_grad_(True)
    want = sum(ref.dispatch_onehot_ref(xb, idx[:, j], slot[:, j], E,
                                       capacity) for j in range(k))
    torch.testing.assert_close(buf, want.detach(), rtol=0, atol=0)
    (want * buf_g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=1e-6)

    src = torch.from_numpy(rng.normal(size=(E, capacity, d)).astype(
        np.float32))
    ba, wa = src.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (ops.CombineSlots.apply(ba, idx, slot, wa) * y_g).sum().backward()
    bb, wb = src.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (ref.combine_slots_ref(bb, idx, slot, wb) * y_g).sum().backward()
    torch.testing.assert_close(ba.grad, bb.grad, rtol=0, atol=1e-6)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-6)
    dropped = slot >= capacity
    assert bool(dropped.any()) == (capacity == 3)
    assert (wa.grad[dropped] == 0).all()
    torch.testing.assert_close(
        ref.combine_weight_grad_ref(y_g, src, idx, slot), wb.grad,
        rtol=1e-6, atol=1e-6)
