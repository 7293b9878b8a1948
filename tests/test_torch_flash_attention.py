"""The port's flash attention (its plain version, which CPU tensors take)
against the reference on the CPU: the Pallas kernel in interpret mode, the
dense-softmax oracle and the model's ``chunked_attention``, on the shapes
and variants of ``tests/test_flash_attention_kernel.py`` and at the same
tolerances (float32 2e-5, bfloat16 3e-2).  Inputs are drawn with numpy in
float32 and handed to both packages, so bfloat16 inputs round alike."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mk(B, S, H, KH, D, dtype, seed=0, Sk=None, Dv=None):
    rng = np.random.default_rng(seed)
    Sk, Dv = Sk or S, Dv or D
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, D), (B, Sk, KH, D), (B, Sk, KH, Dv))]
    return ([jnp.asarray(a, _JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(_TDT[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _j_dense(qj, kj, vj, **kw):
    out = j_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                vj.transpose(0, 2, 1, 3), **kw)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,KH,D", [
    (2, 128, 4, 4, 32),   # MHA
    (1, 256, 8, 2, 16),   # GQA
    (2, 64, 4, 1, 64),    # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_reference(B, S, H, KH, D, dtype):
    (qj, kj, vj), (qt, kt, vt) = _mk(B, S, H, KH, D, dtype)
    got = ops.flash_attention(qt, kt, vt, q_blk=32, kv_blk=64)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, D)
    tol = 2e-5 if dtype == "float32" else 3e-2
    pallas = j_flash(qj, kj, vj, q_blk=32, kv_blk=64, interpret=True)
    dense = _j_dense(qj, kj, vj, causal=True).astype(_JDT[dtype])
    for want in (pallas, dense):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window,cap", [
    (True, 16, None), (False, None, None), (True, None, 30.0)])
def test_flash_plain_version_variants(causal, window, cap):
    (qj, kj, vj), (qt, kt, vt) = _mk(1, 128, 4, 2, 32, "float32", seed=3)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                              cap=cap, q_blk=32, kv_blk=32)
    pallas = j_flash(qj, kj, vj, causal=causal, window=window, cap=cap,
                     q_blk=32, kv_blk=32, interpret=True)
    dense = _j_dense(qj, kj, vj, causal=causal, window=window, cap=cap)
    for want in (pallas, dense):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


def test_port_chunked_attention_matches_model_chunked_attention():
    (qj, kj, vj), (qt, kt, vt) = _mk(2, 128, 8, 4, 32, "float32", seed=7)
    got = chunked_attention(qt, kt, vt, causal=True, q_chunk=64,
                            kv_chunk=64)
    want = j_chunked(qj, kj, vj, causal=True, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_offset,window,cap,Dv", [
    (64, None, None, 32), (32, 24, 50.0, 16), (0, None, None, 48)])
def test_chunked_attention_offset_and_value_width(q_offset, window, cap, Dv):
    """``q_offset`` (queries after a prefix of keys) and a value width
    other than the key width, as the model's chunked_attention takes
    them."""
    (qj, kj, vj), (qt, kt, vt) = _mk(1, 64, 4, 2, 32, "float32", seed=11,
                                     Sk=64 + q_offset, Dv=Dv)
    got = chunked_attention(qt, kt, vt, causal=True, q_offset=q_offset,
                            window=window, cap=cap, q_chunk=32, kv_chunk=32)
    want = j_chunked(qj, kj, vj, causal=True, q_offset=q_offset,
                     window=window, cap=cap, q_chunk=32, kv_chunk=32)
    assert got.shape == (1, 64, 4, Dv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_plain_version_tiles_do_not_change_the_answer():
    """Query and key tiles only bound memory: a ragged tiling agrees with
    the dense oracle of the port."""
    _, (qt, kt, vt) = _mk(2, 100, 4, 2, 16, "float32", seed=5)
    got = ref.flash_attention_ref(qt, kt, vt, causal=True, window=30,
                                  q_blk=48, kv_blk=28)
    dense = ref.attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                              vt.transpose(1, 2), causal=True, window=30)
    torch.testing.assert_close(got, dense.transpose(1, 2), rtol=2e-5,
                               atol=2e-5)


def _bf(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype,D,Dv,kernel_name", [
    (torch.bfloat16, 128, 128, "flash_attention"),       # the prefill's
    (torch.bfloat16, 80, 96, "flash_attention"),         # HuBERT's D
    (torch.bfloat16, 256, 256, "flash_attention"),       # Gemma-2's D
    (torch.bfloat16, 16, 32, "flash_attention"),
    (torch.float32, 128, 128, "flash_attention_f32"),
    (torch.float32, 24, 40, "flash_attention_f32"),      # any D up to 256
])
def test_select_kernel_by_dtype_and_shape(dtype, D, Dv, kernel_name):
    """The choice needs no card: bfloat16 goes to the tensor-core kernel,
    float32 to the SIMT kernel, each named by its launch counter."""
    from repro_torch.device import LAUNCHES
    from repro_torch.kernels.flash_attention import kernel

    q, k, v = (_bf(2, 40, 8, D, dtype=dtype), _bf(2, 40, 2, D, dtype=dtype),
               _bf(2, 40, 2, Dv, dtype=dtype))
    assert kernel.select_kernel(q, k, v) == kernel_name
    assert kernel_name in LAUNCHES


def test_select_kernel_takes_aligned_views():
    """A slice of a fused projection and a transpose keep 16-byte strides;
    a dimension of size 1 may carry any stride."""
    from repro_torch.kernels.flash_attention import kernel

    fused = _bf(2, 40, 9, 64)
    k = _bf(2, 2, 40, 64).transpose(1, 2)
    assert kernel.select_kernel(fused[:, :, 1:], k, k) == "flash_attention"
    one = _bf(1, 40, 1, 64).as_strided((1, 40, 1, 64), (7, 64, 3, 1))
    assert kernel.tma_strides(one) == (40 * 64, 64, 64)
    assert kernel.select_kernel(one, one, one) == "flash_attention"


@pytest.mark.parametrize("case,match", [
    ("d24", "multiples of 16"),
    ("d272", "exceed 256"),
    ("dv8", "multiples of 16"),
    ("stride", "16 bytes"),
    ("base", "16-byte-aligned base"),
    ("float16", "no kernel takes"),
    ("mixed", "differs from q's"),
    ("gqa", "do not group"),
    ("no_keys", "at least one key"),
])
def test_select_kernel_refuses_what_no_kernel_takes(case, match):
    from repro_torch.kernels.flash_attention import kernel

    q, k, v = _bf(1, 8, 4, 64), _bf(1, 8, 2, 64), _bf(1, 8, 2, 64)
    if case == "d24":
        q, k, v = _bf(1, 8, 4, 24), _bf(1, 8, 2, 24), _bf(1, 8, 2, 24)
    elif case == "d272":
        q, k, v = _bf(1, 8, 4, 272), _bf(1, 8, 2, 272), _bf(1, 8, 2, 272)
    elif case == "dv8":
        v = _bf(1, 8, 2, 8)
    elif case == "stride":   # rows 68 bf16 (136 bytes) apart
        q = _bf(1, 8, 4, 68)[..., :64]
    elif case == "base":     # starts 8 bytes into its storage
        q = _bf(1, 8, 4, 68)[..., 4:]
        q = q.as_strided((1, 8, 4, 64), (8 * 4 * 64, 4 * 64, 64, 1))
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.float()
    elif case == "gqa":
        k, v = _bf(1, 8, 3, 64), _bf(1, 8, 3, 64)
    elif case == "no_keys":
        k, v = _bf(1, 0, 2, 64), _bf(1, 0, 2, 64)
    with pytest.raises(ValueError, match=match):
        kernel.select_kernel(q, k, v)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper only launches; CPU tensors take the plain version in
    ``ops``, never the kernel module."""
    from repro_torch.kernels.flash_attention import kernel

    q = _bf(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_fwd(q, q, q, scale=0.125)


#: (B, Sq, Sk, H, KH, D, Dv, causal, window, cap, q_offset): the bf16
#: backward kernel's cases, rows that see no key included
_BF16_BWD_CASES = [
    (2, 40, 40, 4, 2, 32, 32, True, None, None, 0),
    (1, 37, 50, 4, 4, 48, 32, True, None, 30.0, 13),
    (2, 30, 20, 4, 2, 16, 16, True, 6, None, 17),    # rows see no key
    (1, 24, 33, 2, 1, 64, 48, False, 9, 20.0, 4),
]


@pytest.mark.parametrize("case", _BF16_BWD_CASES)
def test_bf16_backward_plain_version_works_in_float32(case):
    """``flash_attention_bwd_ref`` on bf16 q, k, v and dO (the plain version
    the bf16 backward kernel is held to) does its arithmetic in float32
    and returns float32: with the float32 forward's output and logsumexp
    of the same values it equals autograd through ``flash_attention_ref``
    on the float32 copies within 1e-5 of each gradient's largest
    magnitude; with the bf16 output too, it equals itself on float32
    copies of every input within 1e-6 (no bf16 rounding inside).  The
    bf16 ``return_lse`` plain path gives the float32 copies' logsumexp,
    +inf on the same rows."""
    B, Sq, Sk, H, KH, D, Dv, causal, window, cap, q_offset = case
    rng = np.random.default_rng(17)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .bfloat16() for s in ((B, Sq, H, D), (B, Sk, KH, D),
                                        (B, Sk, KH, Dv), (B, Sq, H, Dv)))
    opts = dict(causal=causal, window=window, cap=cap, scale=D ** -0.5,
                q_offset=q_offset)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out, lse = ref.flash_attention_ref(*leaves, return_lse=True, q_blk=16,
                                       kv_blk=16, **opts)
    (out * g.float()).sum().backward()
    got = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse, g,
                                      q_blk=16, **opts)
    for what, a, t in zip("qkv", got, leaves):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, t.grad, rtol=0,
                                   atol=1e-5 * float(t.grad.abs().max()),
                                   msg=f"d{what}")
    out16, lse16 = ref.flash_attention_ref(q, k, v, return_lse=True,
                                           q_blk=16, kv_blk=16, **opts)
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert torch.equal(torch.isinf(lse16), torch.isinf(lse))
    fin = torch.isfinite(lse)
    assert not fin.all() if window == 6 else fin.all()
    torch.testing.assert_close(lse16[fin], lse[fin], rtol=0, atol=1e-6)
    got16 = ref.flash_attention_bwd_ref(q, k, v, out16, lse16, g, q_blk=16,
                                        **opts)
    want16 = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         out16.float(), lse16, g.float(),
                                         q_blk=16, **opts)
    for a, b in zip(got16, want16):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


def test_bf16_backward_kernel_wrapper_refuses_what_it_cannot_take():
    """The backward wrapper takes CUDA tensors only and, in bf16, a
    16-byte-aligned ``dout``; ``aligned16`` reads the rule without a card
    and ``FlashAttention`` copies a ``dout`` that breaks it."""
    from repro_torch.kernels.flash_attention import kernel

    q = _bf(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_bwd(q, q, q, q, lse, q, scale=0.125)
    assert kernel.aligned16(q)
    assert not kernel.aligned16(_bf(1, 8, 2, 68)[..., :64])
    assert not kernel.aligned16(_bf(1, 8, 2, 68)[..., 4:])
    assert kernel.aligned16(_bf(1, 8, 2, 68, dtype=torch.float32)[..., :64])


@pytest.mark.parametrize("D,Dv,dtype", [(24, 16, "float32"),
                                        (24, 16, "bfloat16"),
                                        (8, 20, "float32"),
                                        (40, 40, "bfloat16")])
def test_zero_padded_head_dims_equal_the_unpadded_plain_version(D, Dv, dtype):
    """What ``ops.flash_attention`` does for a bf16 head dim that the
    kernel does not take (DeepSeek-V2-Lite's smoke MLA: q/k 24, v 16):
    q, k and v zero-padded to multiples of 16 by ``ops._pad16``, run with
    the unpadded D's scale, the output sliced back to Dv.  It equals the
    plain version on the unpadded inputs in values and in the gradients of
    q, k and v (which come back through the pad at the unpadded widths),
    and the reference's chunked attention at the same widths."""
    (qj, kj, vj), (qt, kt, vt) = _mk(2, 48, 4, 2, D, dtype, seed=13, Dv=Dv)
    g = torch.from_numpy(np.random.default_rng(14).normal(
        size=(2, 48, 4, Dv)).astype(np.float32)).to(_TDT[dtype])
    opts = dict(causal=True, window=None, cap=30.0, scale=D ** -0.5,
                q_offset=0, q_blk=16, kv_blk=16)
    runs = {}
    for name in ("padded", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
        args = ([ops._pad16(t) for t in leaves] if name == "padded"
                else leaves)
        if name == "padded":
            assert all(a.shape[-1] % 16 == 0 and a.is_contiguous()
                       for a in args)
        out = ref.flash_attention_ref(*args, **opts)[..., :Dv]
        (out.float() * g.float()).sum().backward()
        runs[name] = (out.detach(), [t.grad for t in leaves])
    (out, grads), (want, wgrads) = runs["padded"], runs["plain"]
    assert out.shape == want.shape == (2, 48, 4, Dv)
    tol = 1e-6 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for a, b, t in zip(grads, wgrads, (qt, kt, vt)):
        assert a.shape == t.shape and a.dtype == t.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * float(b.float().abs().max()))
    jwant = j_chunked(qj, kj, vj, causal=True, cap=30.0, q_chunk=16,
                      kv_chunk=16)
    jtol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(out), _np(jwant), rtol=jtol, atol=jtol)
