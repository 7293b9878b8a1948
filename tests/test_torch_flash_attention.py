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
