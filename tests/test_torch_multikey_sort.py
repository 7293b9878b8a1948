"""Parity of the port's multi-key sort with the reference on the CPU.

The reference's ops run their Pallas tile sorter in interpret mode (as
``tests/test_kernels.py`` runs it); the port's ops take their plain version
(a CPU tensor).  Both get the same numpy inputs.  Permutations and sorted
tiles must be equal exactly: a sort has no rounding.  ``sort_perm_device``
is held against the reference engine's ``_multikey_perm`` for every key
dtype the engine sorts, floats with -0.0, NaN and infinities included,
with and without a validity mask.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.tensor_engine import _multikey_perm  # noqa: E402
from repro.kernels.multikey_sort import ops as jops  # noqa: E402
from repro.kernels.multikey_sort.ref import tile_sort_ref as j_tile_ref  # noqa: E402
from repro_torch.core.tensor_engine import _lex_perm, sort_perm_device  # noqa: E402
from repro_torch.kernels.multikey_sort import ops, ref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_perm(cols, valid=None):
    out = _multikey_perm(tuple(jnp.asarray(c) for c in cols),
                         None if valid is None else jnp.asarray(valid),
                         len(cols), has_valid=valid is not None)
    return np.asarray(out)


def _port_perm(cols, valid=None):
    return sort_perm_device(tuple(_t(c) for c in cols),
                            None if valid is None else _t(valid)).numpy()


# ---------------------------------------------------------------------------
# The reference's public ops (cases of tests/test_kernels.py and
# tests/test_device_path.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile", [(256, 64), (1024, 256), (2048, 2048)])
@pytest.mark.parametrize("domain", [8, 1 << 20])
def test_tile_sort_matches_reference(n, tile, domain):
    rng = np.random.default_rng(n + domain)
    keys = rng.integers(0, domain, n).astype(np.int32)
    vals = rng.permutation(n).astype(np.int32)
    jk, jv = jops.tile_sort(jnp.asarray(keys), jnp.asarray(vals), tile=tile,
                            interpret=True)
    tk, tv = ops.tile_sort(_t(keys), _t(vals), tile=tile)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rk, rv = ref.tile_sort_ref(_t(keys), _t(vals), tile)
    jrk, jrv = j_tile_ref(jnp.asarray(keys), jnp.asarray(vals), tile)
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))


def test_tile_sort_stability_via_index_payload():
    n = 512
    keys = torch.zeros(n, dtype=torch.int32)  # all equal keys
    vals = torch.arange(n, dtype=torch.int32)
    _, vs = ops.tile_sort(keys, vals, tile=128)
    np.testing.assert_array_equal(vs.numpy(), np.arange(n))


@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_multikey_sort_lsd_matches_reference(nkeys):
    rng = np.random.default_rng(nkeys)
    n = 1024
    cols = [rng.integers(0, 16, n).astype(np.int32) for _ in range(nkeys)]
    want = np.asarray(jops.multikey_sort_lsd(
        tuple(jnp.asarray(c) for c in cols), tile=256, interpret=True))
    got = ops.multikey_sort_lsd(tuple(_t(c) for c in cols), tile=256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n", [0, 1000, 1024, 2500])
def test_multikey_sort_lsd_padded_matches_reference(n):
    rng = np.random.default_rng(37 + n)
    cols = [rng.integers(0, 9, n).astype(np.int32) for _ in range(2)]
    want = np.asarray(jops.multikey_sort_lsd_padded(
        tuple(jnp.asarray(c) for c in cols), tile=256, interpret=True))
    got = ops.multikey_sort_lsd_padded(tuple(_t(c) for c in cols), tile=256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.lexsort(cols[::-1]))


def test_multikey_sort_lsd_requires_whole_tiles():
    col = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        ops.multikey_sort_lsd((col,), tile=256)
    with pytest.raises(ValueError, match="multiple"):
        ops.tile_sort(col, col, tile=256)


# ---------------------------------------------------------------------------
# The engine's sort permutation against the reference engine
# ---------------------------------------------------------------------------

def _keys(dtype: str, n: int, rng) -> np.ndarray:
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(bool)
    if dtype.startswith("float"):
        a = rng.normal(size=n) * 3
        a[rng.integers(0, n, n // 8)] = 0.0
        a[rng.integers(0, n, n // 8)] = -0.0
        a[rng.integers(0, n, n // 16)] = np.nan
        a[rng.integers(0, n, n // 32)] = -np.nan
        a[rng.integers(0, n, n // 32)] = np.inf
        a[rng.integers(0, n, n // 32)] = -np.inf
        return a.astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=np.int64
                        if info.min < 0 else np.uint64,
                        endpoint=True).astype(dtype)


_DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float32",
           "float64"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_sort_perm_device_matches_reference(dtype, masked):
    rng = np.random.default_rng(len(dtype) * 7 + masked)
    n = 3000
    key = _keys(dtype, n, rng)
    major = rng.integers(0, 4, n).astype(np.int64)
    valid = rng.random(n) < 0.6 if masked else None
    for cols in ([key], [major, key], [key, major]):
        np.testing.assert_array_equal(_port_perm(cols, valid),
                                      _ref_perm(cols, valid))


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_wide_unsigned_keys_match_reference(dtype):
    """Keys PyTorch keeps no arithmetic for: the sort reads their bits."""
    rng = np.random.default_rng(3)
    key = _keys(dtype, 2000, rng)
    key[::9] = np.iinfo(dtype).max
    np.testing.assert_array_equal(_port_perm([key]), _ref_perm([key]))


@pytest.mark.parametrize("case", ["empty", "one", "ragged", "all_equal",
                                  "sorted", "reversed"])
def test_sort_perm_device_edge_sizes(case):
    rng = np.random.default_rng(11)
    n = {"empty": 0, "one": 1}.get(case, 1023)  # 1023: no tile multiple
    key = rng.integers(-50, 50, n).astype(np.int64)
    if case == "all_equal":
        key[:] = 7
    elif case == "sorted":
        key.sort()
    elif case == "reversed":
        key = np.sort(key)[::-1].copy()
    minor = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.5
    for cols, v in (([key], None), ([key, minor], None), ([key], valid)):
        got = _port_perm(cols, v)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, _ref_perm(cols, v))


@pytest.mark.parametrize("dtype", _DTYPES + ["uint16", "uint32", "uint64",
                                             "float16"])
def test_radix_pass_matches_a_stable_torch_sort(dtype):
    """One plain radix pass through a permutation against the LSD
    composition the port ran before (``torch.sort`` passes)."""
    rng = np.random.default_rng(5)
    n = 1500
    col = _t(_keys(dtype, n, rng))
    perm = _t(rng.permutation(n))
    want = perm[_lex_perm((col[perm],), n, torch.device("cpu"))]
    assert torch.equal(ref.radix_sort_pass_ref(col, perm), want)
    assert torch.equal(ref.radix_sort_pass_ref(col),
                       _lex_perm((col,), n, torch.device("cpu")))


def _digit_case(case: str, n: int, rng) -> np.ndarray:
    """Columns whose order bits differ in chosen 8-bit digits only."""
    if case == "all_equal":
        return np.full(n, -123456789, np.int64)
    if case == "top_digit":
        return rng.integers(0, 100, n) << 56
    if case == "low_digit":
        return (1234 << 8) + rng.integers(0, 256, n)
    if case == "negative_only":  # raw top byte 0xff, 0x7f after the flip
        return -rng.integers(1, 1 << 20, n)
    if case == "mixed_sign":
        return rng.integers(-1000, 1000, n)
    if case == "o_custkey":
        return rng.integers(1, 150_001, n)
    if case == "signed_zeros":
        return rng.choice([0.0, -0.0], n)
    if case == "zeros_and_nans":
        return rng.choice([0.0, -0.0, np.nan, -np.nan], n).astype(np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("case,mask", [
    ("all_equal", 0), ("top_digit", 0x80), ("low_digit", 0x01),
    ("negative_only", 0x07), ("mixed_sign", 0xFF), ("o_custkey", 0x07),
    ("signed_zeros", 0), ("zeros_and_nans", 0x0C),
])
def test_columns_varying_in_few_digits_match_reference(case, mask):
    """The digits the card's pass sorts on (``digit_mask_ref``: those in
    which the order bits differ) for columns that vary in chosen digits
    only, and the port's permutation on them against the reference
    engine's, with and without a validity mask."""
    rng = np.random.default_rng(19)
    n = 3000
    col = _digit_case(case, n, rng)
    assert ref.digit_mask_ref(_t(col)) == mask
    valid = rng.random(n) < 0.5
    for v in (None, valid):
        np.testing.assert_array_equal(_port_perm([col], v),
                                      _ref_perm([col], v))


@pytest.mark.parametrize("fn", ["radix_sort_pass", "digit_passes_run"])
def test_sort_kernel_wrappers_refuse_cpu_tensors(fn):
    """The CUDA wrappers never fall back: a CPU tensor is refused."""
    from repro_torch.kernels.multikey_sort import kernel

    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernel, fn)(torch.zeros(4, dtype=torch.int64))
