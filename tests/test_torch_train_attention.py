"""The attention backward's plain route on the CPU: gradients through the
port's ``flash_attention`` (autograd through the plain version) and the
backward kernel's plain version ``flash_attention_bwd_ref`` (from the
forward's output and row logsumexp) against ``jax.grad`` of the
reference's ``chunked_attention``: causal and not, window, soft-cap,
q_offset, GQA groups of 1, 2 and 4, Sq != Sk, MLA's D 192 / Dv 128, and
rows that see no key (the mean of V, whose gradient goes to V alone).
Tolerance 1e-5 of each gradient's largest magnitude: float32 sums in
another order (measured under 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

TOL = 1e-5

#: (B, Sq, Sk, H, KH, D, Dv, causal, window, cap, q_offset)
CASES = {
    "causal-gqa2": (2, 32, 32, 4, 2, 16, 16, True, None, None, 0),
    "full-gqa4": (2, 32, 32, 4, 1, 16, 16, False, None, None, 0),
    "mla-192-128": (1, 24, 40, 4, 4, 192, 128, True, None, None, 16),
    "window-cap-nokey": (2, 32, 16, 8, 2, 16, 16, True, 5, 30.0, 8),
    "window-full-nokey": (2, 32, 16, 8, 2, 16, 16, False, 4, None, 14),
    "window-sq-lt-sk": (2, 32, 48, 4, 2, 16, 8, False, 6, None, 3),
}


def _inputs(case, seed=0):
    B, Sq, Sk, H, KH, D, Dv = case[:7]
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, Dv), (B, Sq, H, Dv))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _opts(case):
    causal, window, cap, q_offset = case[7:]
    return dict(causal=causal, window=window, cap=cap, q_offset=q_offset)


def _jax_grads(q, k, v, g, opts):
    def loss(q, k, v):
        out = chunked_attention(q, k, v, q_chunk=8, kv_chunk=8, **opts)
        return jnp.sum(out * g)
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_autograd_through_the_plain_version(name):
    q, k, v, g = _inputs(CASES[name])
    opts = _opts(CASES[name])
    want = _jax_grads(q, k, v, g, opts)
    tq, tk, tv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(tq, tk, tv, q_blk=16, kv_blk=16, **opts)
    (out * torch.from_numpy(g)).sum().backward()
    for what, t, w in zip("qkv", (tq, tk, tv), want):
        _close(t.grad.numpy(), w, f"d{what}")


@pytest.mark.parametrize("name", CASES)
def test_backward_plain_version_matches_jax_grad(name):
    q, k, v, g = _inputs(CASES[name])
    opts = _opts(CASES[name])
    want = _jax_grads(q, k, v, g, opts)
    tq, tk, tv, tg = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **opts)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, q_blk=8,
                                      **opts)
    for what, t, w in zip("qkv", got, want):
        _close(t.numpy(), w, f"d{what}")


def test_lse_marks_the_rows_that_see_no_key():
    """+inf exactly at the rows ``kernel.nokey_from`` names, and the
    logsumexp of the masked scores elsewhere."""
    case = CASES["window-cap-nokey"]
    B, Sq, Sk, H, KH, D = case[:6]
    opts = _opts(case)
    q, k, v, _ = [torch.from_numpy(x) for x in _inputs(case)]
    _, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
    first = kernel.nokey_from(Sq, Sk, causal=opts["causal"],
                              window=opts["window"],
                              q_offset=opts["q_offset"])
    assert 0 < first < Sq
    assert torch.isinf(lse[:, :, first:]).all()
    assert torch.isfinite(lse[:, :, :first]).all()
    # the logsumexp of the visible scaled, capped scores, densely
    G = H // KH
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(G, 2))
    s = torch.tanh(s / D ** 0.5 / opts["cap"]) * opts["cap"]
    pos_q = opts["q_offset"] + torch.arange(Sq)
    pos_k = torch.arange(Sk)
    vis = (pos_q[:, None] >= pos_k) & (pos_q[:, None] - pos_k < opts["window"])
    dense = torch.logsumexp(torch.where(vis, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse[:, :, :first], dense[:, :, :first],
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset,Sq,Sk,want", [
    (True, None, 0, 8, 8, 8), (False, None, 5, 8, 4, 8),
    (True, 3, 0, 8, 8, 8), (True, 3, 6, 8, 4, 0), (False, 2, 2, 8, 4, 3),
    (True, 5, 100, 8, 8, 0)])
def test_nokey_from(causal, window, q_offset, Sq, Sk, want):
    """Against the mask itself: the first row with no visible key."""
    got = kernel.nokey_from(Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset)
    pos_q = q_offset + np.arange(Sq)[:, None]
    pos_k = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= pos_q >= pos_k
    if window is not None:
        vis &= pos_q - pos_k < window
    rows = np.nonzero(~vis.any(1))[0]
    assert got == want == (rows[0] if rows.size else Sq)
    assert rows.size == 0 or (rows == np.arange(rows[0], Sq)).all()
