"""Training data pipeline built on the port's relational engine.  The
reference's code (``src/repro/data/pipeline.py``) over
``repro_torch.core.Executor``:

  1. **dedup**   — self-join on ``content_hash`` (keep lowest doc_id per hash);
  2. **quality filter** — predicate scan;
  3. **length bucketing / packing order** — multi-key sort on
     (domain, bucket, length): the multi-attribute sort of paper §IV.B;
  4. **pack** — greedy fill of (B, S) token rows from the ordered docs.

``PipelineConfig.device`` is the executor's: the CUDA card unless the
caller asks for the CPU, so on the card the tensor path's join and sort
launch the relational kernels (``radix_rank``, ``join_table_build``,
``join_table_probe``, ``radix_sort_pass``).  Under a small ``work_mem``
stages 1 and 3 cross into the spill regime on the linear path, and the
selector routes them to the tensor path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core import Executor, Filter, Join, Relation, Scan, Sort
from .synthetic import synth_corpus, synth_tokens

__all__ = ["PipelineConfig", "prepare_order", "batches", "DataPipeline"]


@dataclasses.dataclass
class PipelineConfig:
    num_docs: int = 20_000
    vocab: int = 32_000
    seq_len: int = 512
    batch_size: int = 8
    min_quality: int = 10
    work_mem: int = 1 << 20
    policy: str = "auto"   # auto | linear | tensor
    seed: int = 0
    device: Optional[str] = None   # the executor's; None: CUDA


def prepare_order(cfg: PipelineConfig):
    """Relational preprocessing; returns (ordered doc relation, op
    metrics, path decisions)."""
    docs = synth_corpus(cfg.num_docs, cfg.vocab, cfg.seed)
    ex = Executor(work_mem=cfg.work_mem, policy=cfg.policy,
                  device=cfg.device)

    # 1. dedup: canonical doc per content_hash (min doc_id), via self-join
    order = np.argsort(docs["doc_id"], kind="stable")
    hashes = docs["content_hash"][order]
    ids = docs["doc_id"][order]
    first_idx = np.unique(hashes, return_index=True)[1]
    canon = Relation({"content_hash": hashes[first_idx],
                      "canon_id": ids[first_idx]})
    joined = ex.execute(Join(Scan(canon), Scan(docs), "content_hash"))
    rel = joined.relation
    keep = rel["doc_id"] == rel["b_canon_id"]
    rel = rel.take(np.nonzero(keep)[0])

    # 2. quality filter + 3. multi-key packing order (domain, bucket, length)
    bucket = (np.log2(np.maximum(rel["length"], 1)).astype(np.int64))
    rel = Relation({**rel.columns, "bucket": bucket})
    res = ex.execute(
        Sort(Filter(Scan(rel), lambda r: r["quality"] >= cfg.min_quality),
             ["domain", "bucket", "length"]))
    metrics = joined.metrics + res.metrics
    decisions = joined.decisions + res.decisions
    return res.relation, metrics, decisions


def batches(cfg: PipelineConfig, ordered: Optional[Relation] = None
            ) -> Iterator[dict]:
    """Yield {"tokens": (B,S) int32, "labels": (B,S) int32} training
    batches (numpy) from ``ordered`` (``prepare_order``'s relation, made
    here when not given)."""
    if ordered is None:
        ordered, _, _ = prepare_order(cfg)
    lengths = ordered["length"]
    doc_ids = ordered["doc_id"]
    toks = synth_tokens(doc_ids, lengths, cfg.vocab, cfg.seed)
    S, B = cfg.seq_len, cfg.batch_size
    need = B * (S + 1)
    pos = 0
    while pos + need <= len(toks):
        block = toks[pos:pos + need].reshape(B, S + 1)
        pos += need
        yield {
            "tokens": block[:, :-1].astype(np.int32),
            "labels": block[:, 1:].astype(np.int32),
        }


class DataPipeline:
    """Stateful wrapper with deterministic resume (the consumed-batch
    counter is part of the training checkpoint)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._consumed = 0

    def state(self) -> dict:
        return {"consumed": self._consumed, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        self._consumed = int(state["consumed"])

    def __iter__(self):
        it = batches(self.cfg)
        for _ in range(self._consumed):  # deterministic skip on resume
            next(it)
        for b in it:
            self._consumed += 1
            yield b
