"""The port's MLA (``repro_torch.models.attention``: ``init_mla``,
``_mla_q``, ``_mla_ckv``, ``mla_forward``, ``mla_decode``) against the
reference's on the CPU, on DeepSeek-V2-Lite's smoke config and the
reference's weights carried across by ``params_from_numpy``: prefill
output and compressed cache within 2e-4, the absorbed decode within 2e-4
step by step, and the absorbed decode equal to the expanded prefill at
every position."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _setup(seed, B=2, S=12, **over):
    cfg = dataclasses.replace(get_smoke_config(ARCH), **over)
    tcfg = dataclasses.replace(t_smoke(ARCH), **over)
    params = JA.init_mla(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    x = np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, params, tp, x


def _tables(cfg, start, S):
    pos = np.arange(start, start + S, dtype=np.int32)[None]
    sj, cj = JC.rope(jnp.asarray(pos), cfg.qk_rope_dim, cfg.rope_theta)
    st, ct = TC.rope(torch.from_numpy(pos), cfg.qk_rope_dim, cfg.rope_theta)
    return (sj, cj), (st, ct)


def test_init_mla_layout_matches_reference():
    cfg, tcfg = get_smoke_config(ARCH), t_smoke(ARCH)
    ref = JA.init_mla(jax.random.PRNGKey(0), cfg)
    got = TA.init_mla(torch.Generator().manual_seed(0), tcfg,
                      device="cpu")
    assert list(got) == list(ref)
    for name, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        node = got
        for p in name:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, name


@pytest.mark.parametrize("over", [{}, {"num_heads": 2, "qk_rope_dim": 4,
                                       "kv_lora_rank": 8}])
def test_mla_projections_match_reference(over):
    cfg, tcfg, params, tp, x = _setup(0, **over)
    (sj, cj), (st, ct) = _tables(cfg, 0, x.shape[1])
    for jf, tf in ((JA._mla_q, TA._mla_q), (JA._mla_ckv, TA._mla_ckv)):
        want = jf(params, jnp.asarray(x), cfg, sj, cj)
        got = tf(tp, torch.from_numpy(x), tcfg, st, ct)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)


@pytest.mark.parametrize("S,q_chunk,kv_chunk", [(12, 256, 1024),
                                                (16, 4, 8)])
def test_mla_forward_matches_reference(S, q_chunk, kv_chunk):
    cfg, tcfg, params, tp, x = _setup(1, S=S)
    (sj, cj), (st, ct) = _tables(cfg, 0, S)
    oj, cache_j = JA.mla_forward(params, jnp.asarray(x), cfg, sj, cj,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    ot, cache_t = TA.mla_forward(tp, torch.from_numpy(x), tcfg, st, ct,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    assert tuple(ot.shape) == (2, S, cfg.d_model)
    assert tuple(cache_t.shape) == (2, S, width)
    _close(ot, oj)
    _close(cache_t, cache_j)


@pytest.mark.parametrize("past", [-1, 0, 3])
def test_mla_decode_matches_reference_and_the_expanded_prefill(past):
    """Step by step from an empty compressed cache: each absorbed step
    equals the reference's step and the expanded prefill's row at its
    position; then one step at ``cur_pos`` = S - 1, S and S + 3 of an
    S-position cache, where the write lands on ``min(cur_pos, S - 1)`` and
    the mask is ``cur_pos``'s, as in the reference."""
    S = 8
    cfg, tcfg, params, tp, x = _setup(2, S=S)
    (sj, cj), (st, ct) = _tables(cfg, 0, S)
    full, _ = TA.mla_forward(tp, torch.from_numpy(x), tcfg, st, ct)
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    cache_j = jnp.zeros((2, S, width), jnp.float32)
    cache_t = torch.zeros((2, S, width))
    for t in range(S):
        (sj1, cj1), (st1, ct1) = _tables(cfg, t, 1)
        oj, cache_j = JA.mla_decode(params, jnp.asarray(x[:, t:t + 1]), cfg,
                                    sj1, cj1, cache_j, t)
        ot, out_cache = TA.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcfg, st1, ct1, cache_t, t)
        assert out_cache is cache_t  # written in place
        _close(ot, oj)
        _close(cache_t, cache_j)
        _close(ot[:, 0], full[:, t].numpy())
    cur = S + past
    x1 = np.random.default_rng(7).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32)
    (sj1, cj1), (st1, ct1) = _tables(cfg, cur, 1)
    oj, cache_j = JA.mla_decode(params, jnp.asarray(x1), cfg, sj1, cj1,
                                cache_j, cur)
    ot, _ = TA.mla_decode(tp, torch.from_numpy(x1), tcfg, st1, ct1, cache_t,
                          cur)
    _close(ot, oj)
    _close(cache_t, cache_j)


def test_mla_bfloat16_decode_keeps_the_cache_dtype():
    """bf16 weights and activations against a bf16 cache: the entry is
    stored in the cache's dtype and the output comes back in x's, as the
    reference's ``astype`` calls have it."""
    cfg, tcfg, params, tp, x = _setup(3, S=4)
    tp16 = {k: (v if not isinstance(v, torch.Tensor) else v.bfloat16())
            for k, v in tp.items()}
    tp16["kv_norm"] = {"scale": tp["kv_norm"]["scale"].bfloat16()}
    (_, _), (st, ct) = _tables(cfg, 2, 1)
    cache = torch.zeros((2, 4, cfg.kv_lora_rank + cfg.qk_rope_dim),
                        dtype=torch.bfloat16)
    out, _ = TA.mla_decode(tp16, torch.from_numpy(x[:, :1]).bfloat16(),
                           tcfg, st, ct, cache, 2)
    assert out.dtype == torch.bfloat16 and cache.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert cache[:, 2].abs().sum() > 0 and cache[:, 3].abs().sum() == 0
