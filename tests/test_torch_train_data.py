"""The port's data pipeline on the CPU: the five cases of
``tests/test_data_pipeline.py`` run through ``repro_torch.data`` (the
relational engine's join and sort on ``device="cpu"``), and its ordered
documents and batches equal the reference's element for element at the
same seed under the ``linear``, ``tensor`` and ``auto`` policies."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro_torch.data.pipeline import (DataPipeline, PipelineConfig,  # noqa: E402
                                       batches, prepare_order)
from repro_torch.data.synthetic import synth_corpus  # noqa: E402

CPU = "cpu"


def test_corpus_has_duplicates():
    docs = synth_corpus(5000, 1000)
    assert len(np.unique(docs["content_hash"])) < len(docs)


@pytest.mark.parametrize("policy", ["linear", "tensor", "auto"])
def test_prepare_order_policies_agree(policy):
    cfg = PipelineConfig(num_docs=3000, policy=policy, work_mem=64 * 1024,
                         device=CPU)
    rel, metrics, decisions = prepare_order(cfg)
    assert len(np.unique(rel["content_hash"])) == len(rel)
    assert rel["quality"].min() >= cfg.min_quality
    d, b, l = rel["domain"], rel["bucket"], rel["length"]
    key = (d.astype(object) * 10**12 + b * 10**6 + l)
    assert np.all(key[:-1] <= key[1:])


def test_policies_produce_identical_order():
    rels = {}
    for policy in ("linear", "tensor"):
        cfg = PipelineConfig(num_docs=3000, policy=policy,
                             work_mem=64 * 1024, device=CPU)
        rels[policy], _, _ = prepare_order(cfg)
    assert rels["linear"].sort_canonical().equals(
        rels["tensor"].sort_canonical())


def test_batches_shape_and_determinism():
    cfg = PipelineConfig(num_docs=2000, seq_len=64, batch_size=4, device=CPU)
    b1 = list(batches(cfg))
    b2 = list(batches(cfg))
    assert len(b1) > 2
    assert b1[0]["tokens"].shape == (4, 64)
    assert b1[0]["labels"].shape == (4, 64)
    np.testing.assert_array_equal(b1[1]["tokens"], b2[1]["tokens"])
    np.testing.assert_array_equal(b1[0]["tokens"][:, 1:],
                                  b1[0]["labels"][:, :-1])


def test_pipeline_resume_deterministic():
    cfg = PipelineConfig(num_docs=2000, seq_len=64, batch_size=4, device=CPU)
    p1 = DataPipeline(cfg)
    it = iter(p1)
    for _ in range(3):
        next(it)
    p2 = DataPipeline(cfg)
    p2.restore(p1.state())
    np.testing.assert_array_equal(next(iter(p2))["tokens"],
                                  next(it)["tokens"])


@pytest.mark.parametrize("policy", ["linear", "tensor", "auto"])
def test_batches_equal_the_reference(policy):
    """The ordered documents column for column and every batch element
    for element, at the reference's defaults (20,000 documents, 1 MB of
    work_mem) and a small spilling budget."""
    for kw in (dict(), dict(num_docs=3000, work_mem=64 * 1024)):
        cfg = PipelineConfig(policy=policy, seq_len=128, batch_size=4,
                             device=CPU, **kw)
        want_cfg = ref_pipeline.PipelineConfig(policy=policy, seq_len=128,
                                               batch_size=4, **kw)
        got, _, _ = prepare_order(cfg)
        want, _, _ = ref_pipeline.prepare_order(want_cfg)
        assert sorted(got.columns) == sorted(want.columns)
        for name in want.columns:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        got_b = list(batches(cfg, got))
        want_b = list(ref_pipeline.batches(want_cfg))
        assert len(got_b) == len(want_b) > 0
        for g, w in zip(got_b, want_b):
            for name in ("tokens", "labels"):
                assert g[name].dtype == w[name].dtype
                np.testing.assert_array_equal(g[name], w[name])
