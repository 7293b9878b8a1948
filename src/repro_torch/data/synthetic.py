"""Synthetic corpus: documents as relations (the data pipeline's raw
input).  A copy of ``src/repro/data/synthetic.py`` over the port's
``core.Relation``: numpy with a seed, so both packages make the same
corpus."""
from __future__ import annotations

import numpy as np

from ..core import Relation

__all__ = ["synth_corpus", "synth_tokens"]


def synth_corpus(num_docs: int, vocab: int, seed: int = 0,
                 mean_len: int = 512) -> Relation:
    """Document metadata table: one row per doc.  ``content_hash`` collides
    for duplicated documents (10% dup rate) so dedup has real work to do."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(8, rng.geometric(1.0 / mean_len, num_docs)).astype(np.int64)
    base_hash = rng.integers(0, 1 << 60, num_docs).astype(np.int64)
    # duplicate ~10% of docs: share another doc's hash & length
    dup = rng.random(num_docs) < 0.10
    src = rng.integers(0, num_docs, num_docs)
    content_hash = np.where(dup, base_hash[src], base_hash)
    lengths = np.where(dup, lengths[src], lengths)
    return Relation({
        "doc_id": np.arange(num_docs, dtype=np.int64),
        "content_hash": content_hash,
        "length": lengths,
        "domain": rng.integers(0, 16, num_docs).astype(np.int64),
        "quality": rng.integers(0, 100, num_docs).astype(np.int64),
    })


def synth_tokens(doc_ids: np.ndarray, lengths: np.ndarray, vocab: int,
                 seed: int = 0) -> np.ndarray:
    """Deterministic per-doc token stream (zipf-ish), concatenated."""
    rng = np.random.default_rng(seed)
    total = int(lengths.sum())
    # zipf via inverse-CDF over a power-law; cheap + heavy-tailed like text
    u = rng.random(total)
    toks = np.minimum((u ** -1.2).astype(np.int64), vocab - 1)
    return toks % vocab
