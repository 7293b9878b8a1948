"""The LINEAR execution path (the paper's baseline).

This is the classic relational execution model the paper critiques: data is
flattened early into linearized intermediates —

  * hash join: the build side is collapsed into an open-addressing hash table
    (a 1-D linear memory structure); when the table exceeds ``work_mem`` the
    operator enters the *spill regime*: Grace-style recursive hash
    partitioning with real temp-file I/O (§VI: T_rel(N) = O(N) + α(N, M)).
  * sort: multi-attribute keys are collapsed into a single comparator
    (np.lexsort); above ``work_mem`` we switch to external merge sort with
    run spilling and multi-pass merges, each pass re-reading and re-writing
    the full dataset (spill amplification).

Everything here runs on the host CPU with numpy — faithful to the paper's
"CPU-based linear execution path" — and accounts every temp byte.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .metrics import OpMetrics, SpillAccount, Timer
from .relation import Relation
from .spill import SpillManager

__all__ = [
    "hash_join_linear",
    "sort_linear",
    "table_bytes_estimate",
    "HashTable",
]

_EMPTY = np.int64(-(2**62))
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
MAX_PARTITION_DEPTH = 6
MAX_FANOUT = 64
MERGE_BUFFER_BYTES = 96 * 1024  # per-run merge read buffer (PG tape buffer analog)
SLOT_BYTES = 16  # key (8B) + row pointer (8B) per open-addressing slot


def _splitmix64(x: np.ndarray, salt: int = 0) -> np.ndarray:
    """Vectorized splitmix64 over int64 keys → uint64 hashes."""
    salt_c = np.uint64((0x9E3779B97F4A7C15 * (salt + 1)) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + salt_c
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _next_pow2(n: int) -> int:
    return 1 << max(4, int(math.ceil(math.log2(max(1, n)))))


def table_bytes_estimate(n_build: int) -> int:
    """Open-addressing table footprint for n rows at load factor <= 0.5."""
    return SLOT_BYTES * _next_pow2(2 * max(1, n_build))


class HashTable:
    """Vectorized open-addressing (linear probing) hash table, int64 keys.

    The linearized intermediate of the paper's §II.B: the build relation is
    flattened into this 1-D slot array.  Duplicate build keys raise
    ``DuplicateKeys`` and the caller falls back to a sort-expand build (the
    semantics stay hash-join; only the duplicate-handling layout changes).
    """

    class DuplicateKeys(Exception):
        pass

    def __init__(self, keys: np.ndarray, salt: int = 0):
        n = len(keys)
        m = _next_pow2(2 * max(1, n))
        self.m = m
        self.salt = salt
        self.keys = keys
        self.tab_key = np.full(m, _EMPTY, dtype=np.int64)
        self.tab_row = np.zeros(m, dtype=np.int64)
        mask = np.uint64(m - 1)
        h = (_splitmix64(keys, salt) & mask).astype(np.int64)
        pending = np.arange(n, dtype=np.int64)
        probe = 0
        while pending.size:
            slots = (h[pending] + probe) & (m - 1)
            slot_keys = self.tab_key[slots]
            empty = slot_keys == _EMPTY
            if empty.any():
                cand_rows = pending[empty]
                cand_slots = slots[empty]
                uniq_slots, first = np.unique(cand_slots, return_index=True)
                winners = cand_rows[first]
                self.tab_key[uniq_slots] = keys[winners]
                self.tab_row[uniq_slots] = winners
                placed = np.zeros(n, dtype=bool)
                placed[winners] = True
                keep = ~placed[pending]
                pending = pending[keep]
                slots = slots[keep]
                slot_keys = self.tab_key[slots]
            # a pending row whose target slot holds its own key value → duplicate
            if pending.size and np.any(slot_keys == keys[pending]):
                raise HashTable.DuplicateKeys()
            probe += 1
            if probe > m:  # pragma: no cover - table provably has free slots
                raise RuntimeError("hash table full")

    @property
    def nbytes(self) -> int:
        return SLOT_BYTES * self.m

    def probe(self, probe_keys: np.ndarray) -> np.ndarray:
        """Return build-row index per probe key (-1 = no match)."""
        m = self.m
        mask = np.uint64(m - 1)
        h = (_splitmix64(probe_keys, self.salt) & mask).astype(np.int64)
        result = np.full(len(probe_keys), -1, dtype=np.int64)
        active = np.arange(len(probe_keys), dtype=np.int64)
        probe = 0
        while active.size:
            slots = (h[active] + probe) & (m - 1)
            sk = self.tab_key[slots]
            hit = sk == probe_keys[active]
            result[active[hit]] = self.tab_row[slots[hit]]
            done = hit | (sk == _EMPTY)
            active = active[~done]
            probe += 1
        return result


def _sort_expand_join(
    build_keys: np.ndarray, probe_keys: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Duplicate-tolerant in-memory join core: returns (build_idx, probe_idx)."""
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    left = np.searchsorted(sk, probe_keys, side="left")
    right = np.searchsorted(sk, probe_keys, side="right")
    counts = right - left
    total = int(counts.sum())
    probe_idx = np.repeat(np.arange(len(probe_keys)), counts)
    starts = np.repeat(left, counts)
    first_out = np.repeat(np.cumsum(counts) - counts, counts)
    offsets = np.arange(total) - first_out
    build_idx = order[starts + offsets]
    return build_idx, probe_idx


def _inmem_join(
    build: Relation, probe: Relation, key: str, peak: List[int]
) -> Relation:
    bk = build[key].astype(np.int64)
    pk = probe[key].astype(np.int64)
    try:
        tab = HashTable(bk)
        peak[0] = max(peak[0], tab.nbytes)
        hit_row = tab.probe(pk)
        matched = hit_row >= 0
        probe_idx = np.nonzero(matched)[0]
        build_idx = hit_row[probe_idx]
    except HashTable.DuplicateKeys:
        build_idx, probe_idx = _sort_expand_join(bk, pk)
        peak[0] = max(peak[0], table_bytes_estimate(len(bk)) + bk.nbytes * 2)
    out = {}
    for name, col in probe.columns.items():
        out[name] = col[probe_idx]
    for name, col in build.columns.items():
        if name == key:
            continue
        out[f"b_{name}"] = col[build_idx]
    if not out:  # key-only join
        out[key] = probe[key][probe_idx]
    peak[0] = max(peak[0], sum(c.nbytes for c in out.values()))
    return Relation(out)


def _grace_join(
    build: Relation,
    probe: Relation,
    key: str,
    work_mem: int,
    mgr: SpillManager,
    spill: SpillAccount,
    peak: List[int],
    depth: int = 0,
    cancel=None,
) -> Relation:
    est = table_bytes_estimate(len(build))
    if est <= work_mem or depth >= MAX_PARTITION_DEPTH or len(build) <= 64:
        return _inmem_join(build, probe, key, peak)
    if cancel is not None:
        # preemption poll: only the spill regime is cancellable — an
        # in-memory join finishes faster than any requeue could
        cancel.check()

    # Spill regime: recursive hash partitioning (Grace hash join).
    build_schema = {k: v for k, v in build.columns.items()}
    probe_schema = {k: v for k, v in probe.columns.items()}
    fanout = int(min(MAX_FANOUT, max(2, _next_pow2(int(math.ceil(est / work_mem))))))
    spill.partition_passes = max(spill.partition_passes, depth + 1)
    observe = getattr(cancel, "observe_fanout", None)
    if observe is not None:
        # execution-time guard: record the partition geometry actually chosen
        observe(est, fanout, depth)
    bh = (_splitmix64(build[key].astype(np.int64), salt=100 + depth) % np.uint64(fanout)).astype(np.int64)
    ph = (_splitmix64(probe[key].astype(np.int64), salt=100 + depth) % np.uint64(fanout)).astype(np.int64)

    # Intra-pass restart checkpoints: by the first pair boundary the whole
    # partitioning pass is sunk cost, so a badly mispriced decision is most
    # profitably abandoned *here*.  Mid-pass there is no reusable prefix —
    # the guard fires a restart SwitchPoint carrying the partial spill
    # files for deletion and the executor re-runs from the base relations.
    part_cp = getattr(cancel, "checkpoint_partition", None) if depth == 0 else None
    rows_total = len(build) + len(probe)
    rows_done = 0
    part_paths = []
    for f in range(fanout):
        if cancel is not None:
            cancel.check()  # per-partition poll: bounded preemption latency
        if part_cp is not None:
            part_cp(rows_done=rows_done, rows_total=rows_total,
                    files=[p for bp, pp, *_ in part_paths
                           for p in (bp, pp) if p],
                    spill=spill)
        b_part = build.take(np.nonzero(bh == f)[0])
        p_part = probe.take(np.nonzero(ph == f)[0])
        rows_done += len(b_part) + len(p_part)
        b_path = mgr.write_relation(b_part, f"jb{depth}", spill) if len(b_part) else None
        p_path = mgr.write_relation(p_part, f"jp{depth}", spill) if len(p_part) else None
        part_paths.append((b_path, p_path, len(b_part), len(p_part)))
    del build, probe  # the operator's working set is now on disk

    prefetch = getattr(mgr, "prefetch", None)
    if prefetch is not None:
        # Tiered manager: stream spilled BUILD partitions back up the
        # hierarchy (T2→T0) in the background while each earlier partition's
        # probe side is still being consumed — overlapping re-read latency
        # with join compute.  Promotion is best-effort: already-read or
        # deleted paths are skipped.
        prefetch([b for b, p, nb, npr in part_paths
                  if b is not None and p is not None and nb and npr])

    # Execution-time guard checkpoints fire only at depth 0, where partial
    # state is a clean prefix: ``results`` holds fully-joined partitions and
    # ``part_paths[i:]`` are untouched spilled pairs a tensor takeover can
    # reuse through the same spill manager.  Inside the recursion a pair is
    # half-consumed and a switch would lose work.
    checkpoint = getattr(cancel, "checkpoint", None) if depth == 0 else None
    results: List[Relation] = []
    for i, (b_path, p_path, nb, npr) in enumerate(part_paths):
        if checkpoint is not None:
            checkpoint(done=results, pending=part_paths[i:], spill=spill,
                       schema_hint=(build_schema, probe_schema))
        if b_path is None or p_path is None or nb == 0 or npr == 0:
            for p in (b_path, p_path):
                if p:
                    mgr.delete(p, spill)
            continue
        b_part = mgr.read_relation(b_path, spill)
        p_part = mgr.read_relation(p_path, spill)
        mgr.delete(b_path, spill)
        mgr.delete(p_path, spill)
        if cancel is not None:
            cancel.check()
        results.append(_grace_join(b_part, p_part, key, work_mem, mgr, spill,
                                   peak, depth + 1, cancel))
    if not results:
        # empty join result with the correct joined schema
        b_empty = Relation({k: v[:0] for k, v in build_schema.items()})
        p_empty = Relation({k: v[:0] for k, v in probe_schema.items()})
        return _inmem_join(b_empty, p_empty, key, peak)
    out = results[0]
    for r in results[1:]:
        out = out.concat(r)
    return out


def hash_join_linear(
    build: Relation,
    probe: Relation,
    key: str,
    work_mem: int,
    mgr: Optional[SpillManager] = None,
    cancel=None,
) -> Tuple[Relation, OpMetrics]:
    """Linear-path hash join with work_mem discipline and real spilling.

    ``cancel`` is an optional preemption token (any object with a
    ``check()`` raising :class:`~repro_torch.core.faults.PreemptedError`): the
    spill regime polls it at partition boundaries so a floor-degraded join
    can abandon its spill mid-flight and be requeued on the tensor path."""
    own_mgr = mgr is None
    mgr = mgr or SpillManager()
    spill = SpillAccount()
    peak = [0]
    try:
        with Timer() as t:
            out = _grace_join(build, probe, key, work_mem, mgr, spill, peak,
                              cancel=cancel)
    finally:
        if own_mgr:
            mgr.cleanup()
    metrics = OpMetrics(
        op="hash_join",
        path="linear",
        rows_in=len(build) + len(probe),
        rows_out=len(out),
        wall_s=t.elapsed,
        spill=spill,
        peak_working_set_bytes=peak[0],
    )
    return out, metrics


# ---------------------------------------------------------------------------
# External merge sort
# ---------------------------------------------------------------------------

def _lexsort_rel(rel: Relation, keys: Sequence[str]) -> Relation:
    order = np.lexsort([rel[k] for k in reversed(keys)])
    return rel.take(order)


def _lex_le_bound(cols: Sequence[np.ndarray], bound: Sequence) -> np.ndarray:
    """Vectorized lexicographic `row <= bound` over key columns."""
    n = len(cols[0])
    result = np.zeros(n, dtype=bool)
    undecided = np.ones(n, dtype=bool)
    for c, b in zip(cols, bound):
        lt = c < b
        gt = c > b
        result |= undecided & lt
        undecided &= ~(lt | gt)
    result |= undecided  # equal on all keys
    return result


def _merge_runs(
    run_paths: List[str],
    keys: Sequence[str],
    mgr: SpillManager,
    spill: SpillAccount,
    row_bytes: int,
    final: bool,
) -> Tuple[Optional[str], Optional[Relation]]:
    """Streaming k-way merge via the splitter technique.

    Rows <= (min over streams of that stream's buffered tail) are globally
    safe to emit; they are cut from every buffer, merged with one lexsort,
    and appended to the output run.
    """
    readers = [mgr.open_run_reader(p, spill) for p in run_paths]
    buf_rows = max(64, MERGE_BUFFER_BYTES // max(1, row_bytes))
    buffers: List[Optional[Relation]] = [r.read_rows(buf_rows) for r in readers]
    out_chunks: List[Relation] = []

    def tail_tuple(rel: Relation):
        return tuple(rel[k][-1] for k in keys)

    while True:
        live = [i for i, b in enumerate(buffers) if b is not None and len(b) > 0]
        if not live:
            break
        # bound = smallest buffered tail among streams that still have data on disk;
        # fully-exhausted streams do not constrain the bound.
        bounding = [i for i in live if not readers[i].exhausted]
        if bounding:
            bound = min(tail_tuple(buffers[i]) for i in bounding)
        else:
            bound = max(tail_tuple(buffers[i]) for i in live)
        take_parts = []
        for i in live:
            b = buffers[i]
            mask = _lex_le_bound([b[k] for k in keys], bound)
            take_idx = np.nonzero(mask)[0]
            if len(take_idx):
                take_parts.append(b.take(take_idx))
                keep_idx = np.nonzero(~mask)[0]
                buffers[i] = b.take(keep_idx) if len(keep_idx) else None
            if (buffers[i] is None or len(buffers[i]) == 0) and not readers[i].exhausted:
                nxt = readers[i].read_rows(buf_rows)
                buffers[i] = nxt if len(nxt) else None
        if not take_parts:
            continue
        merged = take_parts[0]
        for p in take_parts[1:]:
            merged = merged.concat(p)
        out_chunks.append(_lexsort_rel(merged, keys))

    result = out_chunks[0]
    for c in out_chunks[1:]:
        result = result.concat(c)
    for p in run_paths:
        mgr.delete(p, spill)
    if final:
        return None, result
    path = mgr.write_relation(result, "run", spill)
    return path, None


def sort_linear(
    rel: Relation,
    keys: Sequence[str],
    work_mem: int,
    mgr: Optional[SpillManager] = None,
    cancel=None,
) -> Tuple[Relation, OpMetrics]:
    """Linear-path sort: in-memory lexsort or external merge sort with
    spilling.  ``cancel`` as in :func:`hash_join_linear`: polled at run and
    merge-pass boundaries so a degraded external sort is preemptible."""
    own_mgr = mgr is None
    mgr = mgr or SpillManager()
    spill = SpillAccount()
    peak = 0
    try:
        with Timer() as t:
            nbytes = rel.nbytes()
            if nbytes <= work_mem:
                out = _lexsort_rel(rel, keys)
                peak = 2 * nbytes
            else:
                # run generation
                row_bytes = rel.row_bytes()
                rows_per_run = max(64, work_mem // max(1, row_bytes))
                run_paths: List[str] = []
                # mid-pass restart checkpoint: sorted runs carry no
                # reusable cross-path state, so abandoning during run
                # formation (before the sunk cost grows) just deletes the
                # runs written so far and re-runs the tensor sort
                part_cp = getattr(cancel, "checkpoint_partition", None)
                for start in range(0, len(rel), rows_per_run):
                    if cancel is not None:
                        cancel.check()  # per-run poll
                    if part_cp is not None:
                        part_cp(rows_done=start, rows_total=len(rel),
                                files=list(run_paths), spill=spill)
                    chunk = Relation(
                        {k: v[start : start + rows_per_run] for k, v in rel.columns.items()}
                    )
                    run_paths.append(
                        mgr.write_relation(_lexsort_rel(chunk, keys), "run", spill)
                    )
                peak = 2 * rows_per_run * row_bytes
                # multi-pass merge limited by work_mem-funded buffers
                fan_in = max(2, work_mem // MERGE_BUFFER_BYTES - 1)
                # execution-time guard checkpoints at merge-pass boundaries:
                # sort has no reusable cross-path partial order, so a fired
                # guard hands the still-live run paths back for deletion and
                # the tensor sort re-runs from the base relation.
                checkpoint = getattr(cancel, "checkpoint_sort", None)
                out = None
                while True:
                    if cancel is not None:
                        cancel.check()  # per-merge-pass poll
                    if checkpoint is not None:
                        checkpoint(pending=run_paths, spill=spill)
                    spill.partition_passes += 1
                    if len(run_paths) <= fan_in:
                        _, out = _merge_runs(run_paths, keys, mgr, spill, row_bytes, final=True)
                        break
                    next_paths = []
                    for g in range(0, len(run_paths), fan_in):
                        if cancel is not None:
                            cancel.check()
                        group = run_paths[g : g + fan_in]
                        if len(group) == 1:
                            next_paths.append(group[0])
                        else:
                            p, _ = _merge_runs(group, keys, mgr, spill, row_bytes, final=False)
                            next_paths.append(p)
                    run_paths = next_paths
    finally:
        if own_mgr:
            mgr.cleanup()
    metrics = OpMetrics(
        op="sort",
        path="linear",
        rows_in=len(rel),
        rows_out=len(out),
        wall_s=t.elapsed,
        spill=spill,
        peak_working_set_bytes=peak,
    )
    return out, metrics
