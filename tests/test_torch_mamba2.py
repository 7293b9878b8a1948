"""The port's Mamba-2 (``repro_torch.models.mamba2``) against the
reference's on the CPU, on numpy-seeded inputs and the reference's
weights carried across by ``params_from_numpy``: ``ssd_scan`` against the
port's sequential ``ssd_ref`` and the reference's ``ssd_scan`` over the
cases of ``tests/test_mamba2.py``, the initial state carried across
chunks, ``ssd_step`` against the scan's tail, and the block's forward
(conv tail and state carried over ``seq_chunk`` pieces) and decode.
Tolerance 2e-4, the reference test's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import mamba2 as JS  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import mamba2 as TS  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus of normals), A (negative), B and C, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (2, 32, 4, 8, 1, 16),
    (1, 32, 4, 8, 2, 8),   # grouped B/C
])
def test_ssd_scan_matches_sequential_and_reference(chunk, b, s, h, p, g, n):
    j, t = _both(_inputs(0, b, s, h, p, g, n))
    y_seq, st_seq = TS.ssd_ref(*t)
    y, st = TS.ssd_scan(*t, chunk=chunk)
    assert st.dtype == torch.float32 and y.shape == (b, s, h, p)
    torch.testing.assert_close(y, y_seq, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st, st_seq, rtol=TOL, atol=TOL)
    y_j, st_j = JS.ssd_scan(*j, chunk=chunk)
    _close(y, y_j)
    _close(st, st_j)
    y_jr, st_jr = JS.ssd_ref(*j)
    _close(y_seq, y_jr)
    _close(st_seq, st_jr)


def test_ssd_initial_state_carries():
    """scan(first half)'s state feeds the second half: the two halves give
    the whole sequence's outputs and final state, as in the reference."""
    j, t = _both(_inputs(1, 1, 16, 2, 4, 1, 8))
    x, dt, A, B, C = t
    y_full, st_full = TS.ssd_scan(x, dt, A, B, C, chunk=8)
    y1, st1 = TS.ssd_scan(x[:, :8], dt[:, :8], A, B[:, :8], C[:, :8],
                          chunk=8)
    y2, st2 = TS.ssd_scan(x[:, 8:], dt[:, 8:], A, B[:, 8:], C[:, 8:],
                          chunk=8, init_state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(st2, st_full, rtol=TOL, atol=TOL)
    xj, dtj, Aj, Bj, Cj = j
    _, st1_j = JS.ssd_scan(xj[:, :8], dtj[:, :8], Aj, Bj[:, :8], Cj[:, :8],
                           chunk=8)
    y2_j, st2_j = JS.ssd_scan(xj[:, 8:], dtj[:, 8:], Aj, Bj[:, 8:],
                              Cj[:, 8:], chunk=8, init_state=st1_j)
    _close(y2, y2_j)
    _close(st2, st2_j)


def test_ssd_step_matches_scan_tail():
    b, s, h, p, g, n = 2, 9, 2, 4, 1, 8
    j, t = _both(_inputs(2, b, s, h, p, g, n))
    x, dt, A, B, C = t
    _, st_prev = TS.ssd_scan(x[:, :8], dt[:, :8], A, B[:, :8], C[:, :8],
                             chunk=8)
    y_step, st_step = TS.ssd_step(x[:, 8], dt[:, 8], A, B[:, 8], C[:, 8],
                                  st_prev)
    y_seq, st_seq = TS.ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(y_step, y_seq[:, 8].reshape(b, h, p),
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(st_step, st_seq, rtol=TOL, atol=TOL)
    xj, dtj, Aj, Bj, Cj = j
    y_j, st_j = JS.ssd_step(xj[:, 8], dtj[:, 8], Aj, Bj[:, 8], Cj[:, 8],
                            jnp.asarray(st_prev.numpy()))
    _close(y_step, y_j)
    _close(st_step, st_j)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 10, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    _close(TS._causal_conv(*(torch.from_numpy(a) for a in (u, w, bias))),
           JS._causal_conv(*(jnp.asarray(a) for a in (u, w, bias))), 1e-5)


def _block(seed, **over):
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), **over)
    tcfg = dataclasses.replace(t_smoke("mamba2-370m"), **over)
    params = JS.init_mamba2(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, params, params_from_numpy(jax.device_get(params),
                                                device="cpu")


@pytest.mark.parametrize("S,chunk,seq_chunk,over", [
    (16, 128, 2048, {}),
    (32, 4, 8, {}),                    # four pieces, the tail carried
    (24, 4, 8, {"ssm_groups": 2}),     # grouped B/C
])
def test_mamba2_forward_matches_reference(S, chunk, seq_chunk, over):
    cfg, tcfg, params, tp = _block(4, **over)
    x = np.random.default_rng(4).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    yj, (conv_j, st_j) = JS.mamba2_forward(params, jnp.asarray(x), cfg,
                                           chunk=chunk, seq_chunk=seq_chunk)
    yt, (conv_t, st_t) = TS.mamba2_forward(tp, torch.from_numpy(x), tcfg,
                                           chunk=chunk, seq_chunk=seq_chunk)
    _close(yt, yj)
    _close(conv_t, conv_j)
    _close(st_t, st_j)
    assert st_t.dtype == torch.float32


def test_mamba2_decode_matches_reference_and_forward():
    """Token by token from zero state: each step equals the reference's
    step and the block's full-sequence forward at its position, and the
    state after the last step equals the forward's."""
    cfg, tcfg, params, tp = _block(5)
    S = 10
    x = np.random.default_rng(5).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)
    full, (conv_f, st_f) = TS.mamba2_forward(tp, torch.from_numpy(x), tcfg)
    _, nheads, g, n, conv_ch = TS._dims(tcfg)
    conv_t = torch.zeros((2, cfg.conv_width - 1, conv_ch))
    st_t = torch.zeros((2, nheads, cfg.ssm_headdim, n))
    conv_j, st_j = jnp.asarray(conv_t.numpy()), jnp.asarray(st_t.numpy())
    for t in range(S):
        yj, (conv_j, st_j) = JS.mamba2_decode(
            params, jnp.asarray(x[:, t:t + 1]), cfg, conv_j, st_j)
        yt, (conv_t, st_t) = TS.mamba2_decode(
            tp, torch.from_numpy(x[:, t:t + 1]), tcfg, conv_t, st_t)
        _close(yt, yj)
        _close(conv_t, conv_j)
        _close(st_t, st_j)
        _close(yt[:, 0], full[:, t].numpy())
    _close(conv_t, conv_f.numpy())
    _close(st_t, st_f.numpy())


def test_mamba2_bfloat16_keeps_a_float32_state():
    """bf16 weights: the SSD state stays float32 through forward and
    decode, as in the reference, and the outputs come back in bf16."""
    cfg = t_smoke("mamba2-370m")
    p = TS.init_mamba2(torch.Generator().manual_seed(6), cfg, torch.bfloat16,
                       device="cpu")
    assert {p[k].dtype for k in ("dt_bias", "a_log", "d_skip")} == {
        torch.float32}
    assert p["conv_w"].dtype == p["wz"].dtype == torch.bfloat16
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(7)).bfloat16()
    y, (conv, st) = TS.mamba2_forward(p, x, cfg)
    assert y.dtype == conv.dtype == torch.bfloat16
    assert st.dtype == torch.float32
    y1, (conv1, st1) = TS.mamba2_decode(p, x[:, :1], cfg, conv, st)
    assert y1.dtype == torch.bfloat16 and st1.dtype == torch.float32
    assert torch.isfinite(y1.float()).all()
