"""The port's int8 KV cache (``repro_torch.serving.kv_quant``) against the
reference's on the CPU, on the same numpy-seeded inputs: the int8 codes
equal, the scales within rtol 1e-6, and quantized decode attention equal
to the reference's within float32 rounding and within the reference
test's rtol 0.05 / atol 0.02 of unquantized float32 attention."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving.kv_quant as JQ  # noqa: E402
import repro_torch.serving.kv_quant as TQ  # noqa: E402
from repro.models.attention import decode_attention as j_decode  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    decode_attention as t_decode)


def _kv(seed=0, B=2, S=128, KH=4, D=32, outlier=False):
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(B, S, KH, D)).astype(np.float32)
            for _ in range(2))
    if outlier:  # one position a thousand times larger, one exactly zero
        k[:, 7] *= 1000.0
        k[:, 9] = 0.0
    return k, v


def _same_quant(got, want):
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6)


@pytest.mark.parametrize("outlier", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 4, 32), (1, 12, 2, 128)])
def test_quantize_and_dequantize_match_reference(shape, outlier):
    k, _ = _kv(*([0] + list(shape)), outlier=outlier)
    got, want = TQ.quantize_kv(torch.from_numpy(k)), JQ.quantize_kv(
        jnp.asarray(k))
    _same_quant(got, want)
    for t_dt, j_dt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        deq = TQ.dequantize_kv(got, t_dt)
        assert deq.dtype == t_dt
        np.testing.assert_array_equal(
            deq.float().numpy(),
            np.asarray(JQ.dequantize_kv(want, j_dt), np.float32))


def test_bfloat16_input_quantizes_as_the_reference():
    k, _ = _kv(1, 2, 16, 2, 64)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    kj = jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16)
    _same_quant(TQ.quantize_kv(kb), JQ.quantize_kv(kj))


def test_append_matches_reference_and_full_quantization():
    """Appending position by position gives the reference's cache and the
    whole sequence's quantization; a position past the end lands on the
    last one, as ``dynamic_update_slice`` clamps it."""
    k, _ = _kv(2, S=16)
    full = TQ.quantize_kv(torch.from_numpy(k))
    cache = TQ.QuantizedKV(torch.zeros_like(full.q),
                           torch.zeros_like(full.scale))
    jcache = JQ.QuantizedKV(jnp.zeros(full.q.shape, jnp.int8),
                            jnp.zeros(full.scale.shape, jnp.float32))
    for t in list(range(16)) + [19]:
        src = k[:, min(t, 15):min(t, 15) + 1] * (2.0 if t == 19 else 1.0)
        got = TQ.append_quantized(cache, torch.from_numpy(src), t)
        assert got.q is cache.q  # written in place
        jcache = JQ.append_quantized(jcache, jnp.asarray(src), t)
        if t == 15:
            _same_quant(cache, JQ.quantize_kv(jnp.asarray(k)))
            assert torch.equal(cache.q, full.q)
    _same_quant(cache, jcache)


@pytest.mark.parametrize("kw", [{}, {"window": 40}, {"cap": 5.0}])
def test_decode_attention_quantized_matches_reference(kw):
    B, S, H, KH, D = 2, 128, 8, 4, 32
    k, v = _kv(3, B=B, S=S, KH=KH, D=D)
    q = np.random.default_rng(9).normal(size=(B, 1, H, D)).astype(np.float32)
    cur = S - 1
    want = JQ.decode_attention_quantized(
        jnp.asarray(q), JQ.quantize_kv(jnp.asarray(k)),
        JQ.quantize_kv(jnp.asarray(v)), cur, **kw)
    got = TQ.decode_attention_quantized(
        torch.from_numpy(q), TQ.quantize_kv(torch.from_numpy(k)),
        TQ.quantize_kv(torch.from_numpy(v)), cur, **kw)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # against unquantized float32 attention, at the reference's tolerance
    exact = t_decode(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), cur, **kw)
    np.testing.assert_allclose(exact.numpy(), np.asarray(
        j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cur, **kw)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0.05,
                               atol=0.02)
    a, b = exact.numpy().ravel(), got.numpy().ravel()
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.999
