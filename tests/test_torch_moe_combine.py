"""The port's combine over all k routing slots (``ops.combine_slots``: one
launch on the card, its plain version ``combine_slots_ref`` on the CPU)
against the reference's layer body on the CPU: the loop of
``src/repro/kernels/moe_dispatch/ops.py::moe_dispatch_pallas``, one
``combine`` per slot (the Pallas kernel in interpret mode) and ``y + c``.
The routing is handed over as the layer has it: int64 expert ids and int32
slots as strided column views, with dropped experts and overflowing slots.
Tolerances are the reference tests': 1e-5 for float32, 3e-2 for
bfloat16.  Against the port's own two-call composition the result is equal
bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.moe_dispatch import ops as jops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops, ref  # noqa: E402

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _case(T, d, E, C, k, seed):
    """buf ``[E, C, d]`` and a ``[T, k]`` routing: experts in [-1, E]
    (dropped outside [0, E)), slots in [-1, C + C // 4] (overflowing at C
    and above), weights in [0, 1)."""
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(E, C, d)).astype(np.float32)
    idx = rng.integers(-1, E + 1, (T, k)).astype(np.int64)
    slot = rng.integers(-1, C + C // 4 + 1, (T, k)).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    return buf, idx, slot, w


def _views(idx, slot, w):
    """The routing as the layer hands it over: the int64 expert ids a
    column slice of a wider array (as ``_route``'s ``[:, :k]`` of the
    sorted experts), the int32 slots every other column of one."""
    T, k = idx.shape
    wide = np.zeros((T, k + 3), np.int64)
    wide[:, :k] = idx
    pairs = np.zeros((T, 2 * k), np.int32)
    pairs[:, ::2] = slot
    idx_t = torch.from_numpy(wide)[:, :k]
    slot_t = torch.from_numpy(pairs)[:, ::2]
    assert not idx_t.is_contiguous() and not slot_t.is_contiguous()
    return idx_t, slot_t, torch.from_numpy(w)


def _two_call(buf, idx, slot, w):
    """The port's layer body before the combine took all slots at once."""
    y = None
    for j in range(idx.shape[1]):
        c = ops.combine(buf, idx[:, j], slot[:, j], w[:, j])
        y = c if y is None else y + c
    return y


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 100])   # 100: not a whole 16-byte vector
def test_combine_slots_matches_reference_loop(k, dtype, d):
    T, E, C = 64, 4, 24
    buf, idx, slot, w = _case(T, d, E, C, k, 7 * k + d)
    buf_t = torch.from_numpy(buf).to(_TDT[dtype])
    idx_t, slot_t, w_t = _views(idx, slot, w)
    got = ops.combine_slots(buf_t, idx_t, slot_t, w_t)
    assert got.dtype == buf_t.dtype and got.shape == (T, d)
    buf_j = jnp.asarray(buf, _JDT[dtype])
    want = None
    for j in range(k):   # moe_dispatch_pallas's combine loop
        c = jops.combine(buf_j, jnp.asarray(idx[:, j]),
                         jnp.asarray(slot[:, j]), jnp.asarray(w[:, j]),
                         interpret=True)
        want = c if want is None else want + c
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert torch.equal(got, _two_call(buf_t, idx_t, slot_t, w_t))
    dropped = ~(((idx >= 0) & (idx < E) & (slot >= 0) & (slot < C)).any(1))
    assert dropped.any()
    assert (got[torch.from_numpy(dropped)] == 0).all()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_slots_ref_is_the_combine_ref_loop(k, dtype):
    """The plain version is the loop over ``combine_ref`` bit for bit,
    dropped assignments adding +0.0 (so a -0.0 product is lifted to +0.0
    by a later dropped slot, as ``y + c`` lifts it)."""
    T, d, E, C = 50, 36, 3, 8
    buf, idx, slot, w = _case(T, d, E, C, k, 100 + k)
    buf_t = torch.from_numpy(buf).to(_TDT[dtype])
    w[:, 0] = 0.0   # -0.0 products where buf is negative
    idx_t, slot_t, w_t = _views(idx, slot, w)
    got = ref.combine_slots_ref(buf_t, idx_t, slot_t, w_t)
    want = ref.combine_ref(buf_t, idx_t[:, 0], slot_t[:, 0], w_t[:, 0])
    for j in range(1, k):
        want = want + ref.combine_ref(buf_t, idx_t[:, j], slot_t[:, j],
                                      w_t[:, j])
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_combine_slots_needs_a_slot():
    buf = torch.zeros(2, 4, 8)
    empty = torch.zeros(3, 0, dtype=torch.int64)
    with pytest.raises(ValueError):
        ops.combine_slots(buf, empty, empty.int(), empty.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_body_equals_two_call_composition(dtype):
    """``ops.moe_dispatch`` (now one combine over all slots) equals the
    layer body's earlier form, k dispatches, the FFN and k combines added
    in turn, bit for bit; the FFN here is the identity."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    T, E, k = 40, cfg.num_experts, cfg.experts_per_token
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(T, 32)).astype(np.float32)).to(
        _TDT[dtype])
    idx = torch.from_numpy(rng.integers(0, E, (T, k)).astype(np.int64))
    w = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    C = 8   # some assignments overflow

    def identity(params, b, c):
        return b

    got = ops.moe_dispatch(None, x, idx, w, cfg, C, identity)
    slot = ops.expert_slots(idx, E)
    assert (slot >= C).any()
    buf = None
    for j in range(k):
        buf = ops.dispatch(x, idx[:, j], slot[:, j], E, C, buf)
    assert torch.equal(got, _two_call(buf, idx, slot, w))


@pytest.mark.parametrize("ids", [torch.int8, torch.uint8, torch.int16])
def test_ops_take_narrow_integer_ids(ids):
    """Ids in a narrower integer dtype give what int64 ids give, and
    float64 weights what float32 weights give, through ``dispatch``,
    ``combine`` and ``combine_slots`` (the card converts them the same
    way before its launch)."""
    T, d, E, C, k = 30, 24, 4, 12, 2
    buf, idx, slot, w = _case(T, d, E, C, k, 11)
    idx = np.clip(idx, 0, None)   # uint8 holds no -1
    slot = np.clip(slot, 0, None)
    buf_t = torch.from_numpy(buf)
    idx_t, slot_t = torch.from_numpy(idx), torch.from_numpy(slot)
    w_t = torch.from_numpy(w)
    idx_n, slot_n = idx_t.to(ids), slot_t.to(ids)
    assert torch.equal(ops.combine_slots(buf_t, idx_n, slot_n, w_t.double()),
                       ops.combine_slots(buf_t, idx_t, slot_t, w_t))
    assert torch.equal(ops.combine(buf_t, idx_n[:, 1], slot_n[:, 1],
                                   w_t[:, 1].double()),
                       ops.combine(buf_t, idx_t[:, 1], slot_t[:, 1],
                                   w_t[:, 1]))
    x = buf_t[0, :T % C]
    assert torch.equal(ops.dispatch(x, idx_n[:x.shape[0], 0],
                                    slot_n[:x.shape[0], 0], E, C),
                       ops.dispatch(x, idx_t[:x.shape[0], 0],
                                    slot_t[:x.shape[0], 0], E, C))
