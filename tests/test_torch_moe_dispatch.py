"""The port's MoE dispatch and combine (their plain versions, which CPU
tensors take) and its MoE layer against the reference on the CPU: the
cases of ``tests/test_kernels.py`` (overflow and duplicate slots
included) against the Pallas kernels in interpret mode and the one-hot
oracles, the kernel-path layer body (which the model's einsum path
runs) against the reference's einsum path, and
the einsum and sort paths of ``moe_forward`` against each other and the
reference, as in ``tests/test_moe.py``.  Tolerances are the reference
tests': 1e-5 for float32 dispatch, 3e-2 for bfloat16, 2e-5 for the layer
body."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.kernels.moe_dispatch import ops as jops  # noqa: E402
from repro.kernels.moe_dispatch import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops, ref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CFG = get_smoke_config("phi3.5-moe-42b-a6.6b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _routing(T, d, E, C, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    eidx = rng.integers(0, E, T).astype(np.int32)
    slot = rng.integers(0, C + C // 4, T).astype(np.int32)  # overflow mix
    w = rng.random(T).astype(np.float32)
    j = (jnp.asarray(x, _JDT[dtype]), jnp.asarray(eidx), jnp.asarray(slot),
         jnp.asarray(w))
    t = (torch.from_numpy(x).to(_TDT[dtype]), torch.from_numpy(eidx),
         torch.from_numpy(slot), torch.from_numpy(w))
    return j, t


@pytest.mark.parametrize("T,d,E,C", [
    (256, 128, 4, 64),
    (512, 256, 8, 128),
    (1024, 128, 16, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_match_reference(T, d, E, C, dtype):
    (xj, ej, sj, wj), (xt, et, st, wt) = _routing(T, d, E, C, dtype, T + E)
    tol = 1e-5 if dtype == "float32" else 3e-2
    buf = ops.dispatch(xt, et, st, E, C)
    assert buf.dtype == xt.dtype and buf.shape == (E, C, d)
    buf_j = jref.dispatch_ref(xj, ej, sj, E, C)
    for want in (jops.dispatch(xj, ej, sj, E, C, interpret=True), buf_j):
        np.testing.assert_allclose(_np(buf), _np(want), rtol=tol, atol=tol)
    # combine on the same buffer in both packages
    buf_t = torch.from_numpy(np.array(buf_j, np.float32)).to(_TDT[dtype])
    y = ops.combine(buf_t, et, st, wt)
    assert y.dtype == buf_t.dtype and y.shape == (T, d)
    for want in (jops.combine(buf_j, ej, sj, wj, interpret=True),
                 jref.combine_ref(buf_j, ej, sj, wj)):
        np.testing.assert_allclose(_np(y), _np(want), rtol=tol, atol=tol)


def test_duplicate_slots_sum_in_token_order():
    """Tokens that share an (expert, slot) row sum in float32 in ascending
    t; the result equals a float32 loop exactly, and the one-hot oracle
    within rounding."""
    rng = np.random.default_rng(4)
    T, d, E, C = 300, 16, 3, 5
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    e = torch.from_numpy(rng.integers(-1, E + 1, T).astype(np.int32))
    s = torch.from_numpy(rng.integers(-1, C + 2, T).astype(np.int32))
    got = ops.dispatch(x, e, s, E, C)
    want = torch.zeros(E, C, d)
    for t in range(T):
        if 0 <= e[t] < E and 0 <= s[t] < C:
            want[e[t], s[t]] += x[t]
    assert torch.equal(got, want)
    keep = (e >= 0) & (e < E)
    onehot = ref.dispatch_onehot_ref(x[keep], e[keep], s[keep], E, C)
    torch.testing.assert_close(got, onehot, rtol=1e-5, atol=1e-5)


def test_kernel_path_matches_model_einsum_path():
    """The port's layer body on the kernel path (plain versions on the CPU)
    reproduces the reference's einsum dispatch end to end."""
    params = jmoe.init_moe(jax.random.PRNGKey(0), CFG)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    T = 128
    x = np.random.default_rng(1).normal(size=(T, CFG.d_model)).astype(
        np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    idx_j, w_j, _ = jmoe._route(params, xj, CFG)
    idx_t, w_t, _ = tmoe._route(tp, xt, CFG)
    assert np.array_equal(np.asarray(idx_j), idx_t.numpy())
    cap = jmoe.capacity_per_expert(T, CFG.num_experts,
                                   CFG.experts_per_token, CFG.capacity_factor)
    want = jmoe._dispatch_einsum(params, xj, idx_j, w_j, CFG, cap)
    got = ops.moe_dispatch(tp, xt, idx_t, w_t, CFG, cap, tmoe._expert_ffn)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    got_cpu_einsum = tmoe._dispatch_einsum(tp, xt, idx_t, w_t, CFG, cap)
    np.testing.assert_allclose(_np(got_cpu_einsum), _np(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 16.0])
def test_dispatch_paths_agree_and_match_reference(capacity_factor):
    """Same outputs and same dropped tokens on the port's two paths, and
    the reference's outputs."""
    cfg = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    params = jmoe.init_moe(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    x = np.random.default_rng(2).normal(size=(4, 16, cfg.d_model)).astype(
        np.float32)
    y_sort, aux_s = tmoe.moe_forward(tp, torch.from_numpy(x), cfg,
                                     dispatch="sort")
    y_ein, aux_e = tmoe.moe_forward(tp, torch.from_numpy(x), cfg,
                                    dispatch="einsum")
    np.testing.assert_allclose(_np(y_sort), _np(y_ein), rtol=1e-5,
                               atol=1e-5)
    assert float(aux_s) == float(aux_e)
    dropped_sort = (y_sort == 0).all(-1)
    assert torch.equal(dropped_sort, (y_ein == 0).all(-1))
    if capacity_factor < 1.0:
        assert dropped_sort.any()  # the drops are real at low capacity
    y_ref, aux_ref = jmoe.moe_forward(params, jnp.asarray(x), cfg,
                                      dispatch="einsum")
    np.testing.assert_allclose(_np(y_ein), _np(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_e), float(aux_ref), rtol=1e-6)


def test_token_chunks_and_path_choice_match_reference():
    """Token chunks make capacity per chunk, and ``auto`` picks the same
    path from the same shapes as the reference (one device)."""
    params = jmoe.init_moe(jax.random.PRNGKey(3), CFG)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 32, CFG.d_model)).astype(
        np.float32)
    y_t, aux_t = tmoe.moe_forward(tp, torch.from_numpy(x), CFG,
                                  token_chunk=16)
    y_j, aux_j = jmoe.moe_forward(params, jnp.asarray(x), CFG,
                                  token_chunk=16)
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    for args in ((1 << 20, 64, 4096, 2048, 6), (1024, 8, 256, 64, 2),
                 (8192, 16, 1280, 4096, 2)):
        a = tmoe.select_dispatch_path(*args, budget_bytes=2 << 30)
        b = jmoe.select_dispatch_path(*args, budget_bytes=2 << 30)
        assert (a.path, a.onehot_bytes) == (b.path, b.onehot_bytes)
    assert tmoe.capacity_per_expert(8192, 16, 2, 1.25) == 1280
