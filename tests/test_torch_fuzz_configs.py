"""The differential fuzz's configurations that hold the port under memory
pressure and partitioning, on the CPU.

The reference's generator (``tests/test_differential_fuzz.py``: ``Case``,
``oracle``, ``assert_same``, ``assert_sorted``) drives
``repro_torch.core.Session(device="cpu")`` under ``check_case``'s
configurations: ``linear``, ``tensor``, ``tiered`` (a linear session that
spills through the tier staircase at 32 KB of work_mem, its ledger then
balanced) and ``sharded`` (``auto`` with ``max_shards=4``).  Every
configuration must give the numpy oracle's rows exactly, with the packed
device layouts on and off (``REPRO_DEVICE_COMPRESS``), on the pinned
edges (empty sides, single rows, one hot key) and under the ``hypothesis``
property.  ``linear``, ``tensor`` and ``auto`` at 64 MB are also in
``tests/test_torch_session.py``, held against the reference's own runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from test_differential_fuzz import (Case, assert_same, assert_sorted,  # noqa: E402
                                    oracle)
from test_torch_session import _case_query  # noqa: E402

MB = 1 << 20


def configurations(tier_wm=32 * 1024):
    """``test_differential_fuzz.configurations`` on the port."""
    return {
        "linear": T.Session(work_mem=64 * MB, policy="linear", fuse=False,
                            device="cpu"),
        "tensor": T.Session(work_mem=64 * MB, policy="tensor", device="cpu"),
        "tiered": T.Session(work_mem=tier_wm, policy="linear", fuse=False,
                            tiers=T.TierConfig(t1_latency_s=0.0,
                                               t1_gbps=1000.0),
                            device="cpu"),
        "sharded": T.Session(work_mem=64 * MB, policy="auto", max_shards=4,
                             device="cpu"),
    }


def check_case(case: Case, tier_wm=32 * 1024, compress=None, monkeypatch=None):
    """Every configuration against the oracle; ``compress`` pins the
    packed-device-layout toggle for the sweep (through ``monkeypatch``)."""
    if compress is not None:
        monkeypatch.setenv("REPRO_DEVICE_COMPRESS", "1" if compress else "0")
    want = oracle(case)
    for name, sess in configurations(tier_wm).items():
        res = _case_query(sess, T, case).collect()
        got = res.scalar if case.root == "agg" else res.relation
        assert_same(got, want, f"[{name}] {case.describe()}")
        if case.root == "sort":
            assert_sorted(got, ("k", "w"))
        if name == "tiered":
            sess.tier_ledger.verify_balanced()


@pytest.mark.parametrize("seed", range(8))
def test_differential_fuzz_quick(seed):
    check_case(Case(np.random.default_rng(1000 + seed)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("compress", [True, False])
def test_differential_fuzz_compression_toggle(seed, compress, monkeypatch):
    check_case(Case(np.random.default_rng(3000 + seed)), compress=compress,
               monkeypatch=monkeypatch)


def test_differential_fuzz_pinned_edges():
    rng = np.random.default_rng(7)
    for n1, n2, kmax in [(0, 40, 5), (40, 0, 5), (0, 0, 1),
                         (1, 1, 1), (200, 150, 1)]:
        case = Case(rng)
        case.probe = {"k": rng.integers(0, kmax, n1).astype(np.int64),
                      "w": rng.integers(-1000, 1000, n1).astype(np.int64)}
        case.build = {"k": rng.integers(0, kmax, n2).astype(np.int64),
                      "v": rng.integers(-1000, 1000, n2).astype(np.int64)}
        case.filter_thr = None
        case.root = "group"
        case.fn = "sum"
        check_case(case)


def test_differential_fuzz_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
    def prop(seed):
        check_case(Case(np.random.default_rng(seed), max_rows=300))

    prop()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(40))
def test_differential_fuzz_deep(seed):
    case = Case(np.random.default_rng(50_000 + seed), max_rows=12_000,
                neg_keys=True)
    check_case(case, tier_wm=16 * 1024)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_differential_fuzz_deep_compressed_mix(seed, monkeypatch):
    case = Case(np.random.default_rng(90_000 + seed), max_rows=12_000,
                neg_keys=True)
    for compress in (True, False):
        check_case(case, tier_wm=16 * 1024, compress=compress,
                   monkeypatch=monkeypatch)
