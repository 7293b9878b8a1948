"""The port's LM (``repro_torch.models``) against the reference's on the
CPU, for the smoke configs of every registered architecture that decodes
(GQA, MLA, Mamba-2 and the Jamba hybrid; M-RoPE and biased QKV) and, for
forward only, the encoder HuBERT: the same weights (the reference's,
handed across as numpy through ``params_from_numpy``) and the same inputs
give the same ``forward`` logits and MoE aux loss, ``prefill`` logits and
cache, and ``decode_step`` logits step by step.  Tolerance 2e-4, as the
reference's prefill/decode test holds it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as JM  # noqa: E402
import repro_torch.models as TM  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "yi-9b", "gemma2-9b",
         "deepseek-v2-lite-16b", "mamba2-370m", "jamba-1.5-large-398b",
         "qwen2-vl-7b", "starcoder2-15b", "yi-34b"]
#: encoder-only: forward alone
ENCODERS = ["hubert-xlarge"]
TOL = 2e-4


def _inputs(cfg, B, S, seed, start=0):
    """The batch both packages take, as numpy: tokens (or HuBERT's frame
    features), plus M-RoPE's three position streams from ``start``."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_stub":
        batch = {"features": rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    if cfg.mrope_sections:
        batch["positions"] = np.broadcast_to(
            np.arange(start, start + S, dtype=np.int32)[None, None],
            (3, B, S)).copy()
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _step(batch, t):
    """Position t's one-token batch (positions are ``[3, B, S]``)."""
    return {k: (v[..., t:t + 1] if k == "positions" else v[:, t:t + 1])
            for k, v in batch.items()}


def _setup(arch, B=2, S=16, seed=0):
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    assert tcfg == type(tcfg)(**vars(cfg))  # the copied registry agrees
    params = JM.init_model(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    return cfg, tcfg, params, tp, _inputs(cfg, B, S, seed)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS + ENCODERS)
def test_forward_matches_reference(arch):
    cfg, tcfg, params, tp, batch = _setup(arch)
    lj, aux_j, _ = JM.forward(params, cfg, _jax(batch))
    lt, aux_t, _ = TM.forward(tp, tcfg, _torch(batch))
    assert lt.shape == (2, 16, cfg.vocab_size)
    _close(lt, lj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Logits and every cache entry, prefix and stacked slots: K/V, MLA's
    compressed ``ckv``, mamba's conv tail and float32 SSD state."""
    cfg, tcfg, params, tp, batch = _setup(arch, seed=1)
    lj, cj = JM.prefill(params, cfg, _jax(batch))
    lt, ct = TM.prefill(tp, tcfg, _torch(batch))
    _close(lt, lj)
    assert ct["pos"] == int(cj["pos"]) == 16
    n = 0
    for part in ("prefix", "blocks"):
        assert sorted(ct[part] or {}) == sorted(cj[part] or {})
        for slot, entry in (cj[part] or {}).items():
            assert sorted(ct[part][slot]) == sorted(entry)
            for name, arr in entry.items():
                got = ct[part][slot][name]
                assert tuple(got.shape) == arr.shape, (part, slot, name)
                assert str(got.dtype).split(".")[-1] == str(arr.dtype)
                _close(got, arr)
                n += 1
    assert n >= cfg.period


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Step-by-step decode from an empty cache, against the reference and
    against the port's own full-sequence forward."""
    cfg, tcfg, params, tp, batch = _setup(arch, S=8, seed=2)
    step = jax.jit(lambda p, c, b: JM.decode_step(p, cfg, c, b))
    cj = JM.init_cache(cfg, 2, 8)
    ct = TM.init_cache(tcfg, 2, 8, device="cpu")
    outs = []
    for t in range(8):
        one = _step(batch, t)
        lj, cj = step(params, cj, _jax(one))
        lt, ct = TM.decode_step(tp, tcfg, ct, _torch(one))
        _close(lt, lj)
        outs.append(lt)
    assert ct["pos"] == 8
    full, _, _ = TM.forward(tp, tcfg, _torch(batch))
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=5e-2,
                               atol=5e-4)
    # a step past the cache's end writes onto its last position, as the
    # reference's dynamic_update_slice does, and attends to every position
    nxt = _step(_inputs(cfg, 2, 1, seed=3, start=8), 0)
    lj, cj = step(params, cj, _jax(nxt))
    lt, ct = TM.decode_step(tp, tcfg, ct, _torch(nxt))
    _close(lt, lj)
    assert ct["pos"] == int(cj["pos"]) == 9
    for part in ("prefix", "blocks"):  # the cache's state, slot by slot
        for slot, entry in (cj[part] or {}).items():
            for name, arr in entry.items():
                _close(ct[part][slot][name], arr)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _node(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _count(tree):
    return sum(_count(v) if isinstance(v, dict) else 1 for v in tree.values())


@pytest.mark.parametrize("arch", [ARCHS[0], "deepseek-v2-lite-16b",
                                  "mamba2-370m", "jamba-1.5-large-398b"])
def test_init_model_layout_matches_reference(arch):
    """The port's own random init has the reference's keys, shapes and
    dtypes, stacked periods included (mamba's float32 ``dt_bias``,
    ``a_log`` and ``d_skip`` under bf16 weights), and is reproducible from
    its generator's seed."""
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    ref = jax.eval_shape(lambda k: JM.init_model(k, cfg, jnp.bfloat16),
                         jax.random.PRNGKey(0))

    def make():
        gen = torch.Generator().manual_seed(3)
        return TM.init_model(gen, tcfg, torch.bfloat16, device="cpu")

    got, again = make(), make()
    flat_ref = _leaves(ref)
    assert len(flat_ref) > 10 and _count(got) == len(flat_ref)
    for path, leaf in flat_ref:
        node, node2 = _node(got, path), _node(again, path)
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        assert torch.equal(node, node2)


def test_unported_mixers_raise():
    """No mixer is left unported: every registered architecture builds
    its smoke model and decode cache, and no model module of the port
    raises ``NotImplementedError``."""
    from pathlib import Path

    from repro_torch.configs import list_archs

    gen = torch.Generator().manual_seed(0)
    for arch in list_archs():
        cfg = t_smoke(arch)
        params = TM.init_model(gen, cfg, device="cpu")
        assert params["final_norm"]["scale"].shape == (cfg.d_model,)
        if not cfg.is_encoder:
            assert TM.init_cache(cfg, 1, 4, device="cpu")["pos"] == 0
    models = Path(TM.__file__).parent
    assert not [f.name for f in models.glob("*.py")
                if "NotImplementedError" in f.read_text()]
    cfg = t_get_config("phi3.5-moe-42b-a6.6b")
    assert cfg.num_layers == 32 and cfg.d_model == 4096


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_params_from_numpy_carries_every_leaf(arch):
    """The reference's bf16 MLA, mamba (``a_log``, ``dt_bias``,
    ``d_skip``, ``conv_w``, ``conv_b``, …) and MoE trees cross leaf by
    leaf: same keys, shapes, dtypes and bits."""
    cfg = get_smoke_config(arch)
    tree = jax.device_get(JM.init_model(jax.random.PRNGKey(4), cfg,
                                        jnp.bfloat16))
    got = params_from_numpy(tree, device="cpu")
    flat = _leaves(tree)
    assert _count(got) == len(flat)
    for path, leaf in flat:
        node = _node(got, path)
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_params_from_numpy_keeps_bfloat16_and_recasts():
    """bfloat16 leaves (ml_dtypes arrays from ``jax.device_get``) cross
    bit for bit; ``dtype`` recasts floating leaves only."""
    vals = np.array([1.5, -2.0, 3e38, -1e-3, 0.0], np.float32)
    tree = jax.device_get({"a": {"w": jnp.asarray(vals, jnp.bfloat16)},
                           "i": jnp.arange(3, dtype=jnp.int32)})
    got = params_from_numpy(tree, device="cpu")
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].float().numpy(),
                                  np.asarray(tree["a"]["w"], np.float32))
    cast = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert cast["a"]["w"].dtype == torch.float32
    assert cast["i"].dtype == torch.int32


def test_common_pieces_and_loss_match_reference():
    """M-RoPE, the plain GELU MLP and the cross-entropy loss, which the
    three smoke configs do not reach, against the reference's."""
    from repro.models import common as JC
    from repro_torch.models import common as TC

    rng = np.random.default_rng(6)
    pos = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    sj, cj = JC.mrope_freqs(jnp.asarray(pos), 32, 1e4, (4, 6, 6))
    st, ct = TC.mrope_freqs(torch.from_numpy(pos), 32, 1e4, (4, 6, 6))
    _close(st, sj, 1e-5)
    _close(ct, cj, 1e-5)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    _close(TC.apply_rope(torch.from_numpy(x), st, ct),
           JC.apply_rope(jnp.asarray(x), sj, cj), 1e-5)
    mp = JC.init_mlp(jax.random.PRNGKey(1), 16, 24, "gelu")
    h = rng.normal(size=(5, 16)).astype(np.float32)
    _close(TM.common.mlp(params_from_numpy(jax.device_get(mp), "cpu"),
                         torch.from_numpy(h), "gelu"),
           JC.mlp(mp, jnp.asarray(h), "gelu"), 1e-5)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(TM.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))),
        float(JM.cross_entropy_loss(jnp.asarray(logits),
                                    jnp.asarray(labels))), rtol=1e-6)
    assert TM.model_input_dtypes(t_smoke("qwen2-vl-7b")) == \
        JM.model_input_dtypes(get_smoke_config("qwen2-vl-7b"))


def test_route_breaks_ties_as_the_reference_does():
    """A router with three equal columns ties experts 1, 2 and 3 on every
    token: ``_route`` picks the lower expert first, as ``jax.lax.top_k``
    does, and ``moe_forward`` on both dispatch paths gives the reference's
    output."""
    from repro.models import moe as JMoE
    from repro_torch.models import moe as TMoE

    arch = "phi3.5-moe-42b-a6.6b"
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    params = jax.device_get(JMoE.init_moe(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(5)
    router = (rng.normal(size=(cfg.d_model, cfg.num_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    params = dict(params, router=router)
    tp = params_from_numpy(params, device="cpu")
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    flat = x.reshape(-1, cfg.d_model)
    idx_j, w_j, aux_j = JMoE._route(params, jnp.asarray(flat), cfg)
    idx_t, w_t, aux_t = TMoE._route(tp, torch.from_numpy(flat), tcfg)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(w_t, w_j, 1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    for dispatch in ("einsum", "sort"):
        yj, _ = JMoE.moe_forward(params, jnp.asarray(x), cfg,
                                 dispatch=dispatch)
        yt, _ = TMoE.moe_forward(tp, torch.from_numpy(x), tcfg,
                                 dispatch=dispatch)
        _close(yt, yj)


@pytest.mark.parametrize("past", [-1, 0, 3])
def test_gqa_decode_at_and_past_the_cache_end_matches_reference(past):
    """``gqa_decode`` at ``cur_pos`` = S - 1, S and S + 3 of an S-position
    cache: the write lands on position ``min(cur_pos, S - 1)`` and the step
    attends with ``cur_pos``'s mask, as in the reference."""
    from repro.models import attention as JA
    from repro.models import common as JC
    from repro_torch.models import attention as TA
    from repro_torch.models import common as TC

    arch = "yi-9b"
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    params = JA.init_gqa(jax.random.PRNGKey(6), cfg)
    tp = params_from_numpy(jax.device_get(params), device="cpu")
    B, S, KH, Dh = 2, 8, cfg.num_kv_heads, cfg.head_dim
    cur = S + past
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, S, KH, Dh)).astype(np.float32)
              for _ in range(2))
    pos = np.full((1, 1), cur, np.int32)
    sj, cj = JC.rope(jnp.asarray(pos), Dh, cfg.rope_theta)
    st, ct = TC.rope(torch.from_numpy(pos), Dh, tcfg.rope_theta)
    oj, (kj, vj) = JA.gqa_decode(params, jnp.asarray(x), cfg, sj, cj,
                                 jnp.asarray(kc), jnp.asarray(vc), cur)
    ot, (kt, vt) = TA.gqa_decode(tp, torch.from_numpy(x), tcfg, st, ct,
                                 torch.from_numpy(kc.copy()),
                                 torch.from_numpy(vc.copy()), cur)
    _close(ot, oj)
    _close(kt, kj)
    _close(vt, vj)
