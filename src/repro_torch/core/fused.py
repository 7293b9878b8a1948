"""Fused device-resident pipelines: Join→[Filter]→[Sort]→[Aggregate] as ONE
device program.

The seed executor lowered every intermediate to a host-numpy Relation between
operators — its own premature materialization.  This module runs the common
pipeline fragment as a single device program (a sequence of torch launches
with no host round trip between them) that:

  * carries **gather indices** between the fused operators (late
    materialization): the join emits index arrays, the filter emits a mask,
    the sort permutes the indices — payload columns are gathered on device
    only at the moment a stage actually consumes them, and columns nobody
    consumes never move at all;
  * keeps every shape **static and bucketed**: input columns are padded to
    power-of-two buckets and join capacity is a power-of-two bucket, so
    repeated queries (even with drifting row counts) hit the same cached
    program — cache keys are
    ``(fragment shape, capacity, input buckets, dtypes, num sort keys, agg)``;
  * performs **≤ 1 device→host transfer per query** on the happy path: the
    single batched fetch of the root result (plus the piggybacked exact match
    count).  If the optimistic capacity bucket overflows — detected from that
    same fetch, never from a separate sync — the run loop re-runs at the exact
    bucket, which the cache then holds for every later query of that shape.

Host-side planning (capacity estimation from a key sample) reads only the
numpy inputs and costs no device traffic.  The dense join core runs the
hand-written radix-join kernels (``kernels/segment_join``) on a CUDA device
at every domain size.

``run_fused(shards=N)`` runs an eligible aggregate fragment
partition-parallel (:func:`sharded_supported`): both sides are
co-partitioned by a hash of the join key on the host
(:mod:`repro_torch.core.partition`), and one batched program joins every
partition's pre-sorted build run at once over ``(N, bucket)`` tensors on the
one device, where the reference runs one partition per mesh device under
``shard_map``; the broker's gang lease holds one logical lane per partition.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_host
from ..distributed.sharding import available_partitions
from .codec_device import decode_device, dict_bucket, take
from .metrics import OpMetrics, SpillAccount, Timer
from .partition import get_partitioned_columns, partition_bucket
from .relation import Relation, column_token
from .table_cache import get_device_layouts, key_stats
from .tensor_engine import (_lex_perm, _order_key, capacity_bucket,
                            dense_domain, radix_hash_probe_dispatch)

__all__ = ["FusedSpec", "PredicateError", "device_mask", "match_fragment",
           "run_fused", "sharded_supported", "pipeline_cache_info",
           "pipeline_cache_clear"]

_I64_MAX = np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# Fragment description + plan matching
# ---------------------------------------------------------------------------

import types

_VALUE_TYPES = (int, float, complex, bool, str, bytes, type(None),
                types.ModuleType)


def _value_safe(v) -> bool:
    """Is ``v`` safe to compare *by value* in a cache key?  Only immutable
    primitives (and module references, which act as namespaces) qualify —
    an object with the default identity hash can mutate underneath while
    its key stays equal, which would resurrect a stale cached program."""
    if isinstance(v, tuple):
        return all(_value_safe(x) for x in v)
    return isinstance(v, _VALUE_TYPES)


def _freeze(v):
    """Type-tagged value for a cache key.  Python equates ``1 == 1.0 ==
    True`` while the cached program bakes the concrete dtype in, so a
    captured value rebound across those types must be a different cache
    entry, not a dict-key collision resurrecting the stale program."""
    if isinstance(v, tuple):
        return ("tuple",) + tuple(_freeze(x) for x in v)
    return (type(v).__name__, v)


def _predicate_key(fn: Optional[Callable]):
    """Cache identity for a filter predicate.

    IR-built predicates (:class:`repro_torch.core.expr.Expr`) carry their
    own canonical :meth:`~repro_torch.core.expr.Expr.cache_token` —
    structural value identity with no bytecode inspection at all; this is
    the primary path for queries built through
    :mod:`repro_torch.core.session`.

    Legacy lambdas fall back to bytecode keying: plans typically rebuild
    their predicate lambda per query; keying on ``id(fn)`` would miss the
    cache every time and pin each dead lambda alive inside a compiled
    program.  Identical code at the same source location with equal
    closure/default/global captures is the same predicate — but only when
    every captured value is value-comparable (:func:`_value_safe`), and
    captured values are *type-tagged* (:func:`_freeze`) so rebinding a
    cell across equal-comparing types (``1`` → ``1.0`` → ``True``) is a
    different entry.  Anything else (mutable objects, arrays, nested
    functions) falls back to object identity: fresh lambdas then get a
    fresh cache entry (correct, just slower).
    """
    if fn is None:
        return None
    from .expr import CombinedPredicate, Expr

    if isinstance(fn, Expr):
        return ("expr", fn.cache_token())
    if isinstance(fn, CombinedPredicate):
        # planner-merged mixed conjunction: compose the per-part keys so a
        # replanned query (fresh wrapper, same parts) stays one cache entry
        return ("and",) + tuple(_predicate_key(p) for p in fn.parts)
    try:
        code = fn.__code__
        cells = tuple(c.cell_contents for c in (fn.__closure__ or ()))
        # referenced globals are baked into the cached program too — a
        # module-level THRESHOLD change must be a different cache entry
        globs = tuple((nm, fn.__globals__.get(nm)) for nm in code.co_names)
        defaults = fn.__defaults__ or ()
        if not (_value_safe(cells) and _value_safe(defaults)
                and all(_value_safe(v) for _, v in globs)):
            return ("id", id(fn))
        key = ("code", code.co_filename, code.co_firstlineno, code.co_code,
               code.co_consts, _freeze(cells),
               tuple((nm, _freeze(v)) for nm, v in globs), _freeze(defaults))
        hash(key)
        return key
    except Exception:
        return ("id", id(fn))


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """A fusable plan fragment over a Scan join: ``[Project](Aggregate?(
    Sort?(Filter?(Join))))``.  ``project`` narrows a relation root's output
    schema — projected-away columns are never gathered and never cross the
    device→host boundary."""

    join_key: str
    filter_fn: Optional[Callable]  # predicate over a column view, or None
    sort_keys: Tuple[str, ...]     # () = no sort stage
    agg: Optional[Tuple[str, str]]  # (column, fn) for a scalar root, or None
    project: Optional[Tuple[str, ...]] = None  # relation-root column subset

    def cache_signature(self) -> Tuple:
        return (self.join_key, _predicate_key(self.filter_fn),
                self.sort_keys, self.agg, self.project)


def match_fragment(plan):
    """Recognize Aggregate?(Sort?(Filter?(Join(Scan, Scan)))) fragments.

    Returns ``(spec, build_relation, probe_relation)`` or None.  At least one
    of the Filter/Sort/Aggregate stages must be present (a bare join gains
    nothing from fusion over the device-resident per-op path; a filtered
    join does — the predicate folds into the validity mask, and the
    planner's pushed-down filters keep multi-join stages on this path).
    """
    from .executor import Aggregate, Filter, Join, Project, Scan, Sort

    node = plan
    agg = None
    sort_keys: Tuple[str, ...] = ()
    filter_fn = None
    project = None
    if isinstance(node, Project):
        project = tuple(node.columns)
        node = node.child
    if isinstance(node, Aggregate):
        if project is not None:
            return None  # Project(Aggregate) is not a planner shape
        agg = (node.column, node.fn)
        node = node.child
    if isinstance(node, Sort):
        sort_keys = tuple(node.keys)
        node = node.child
    if isinstance(node, Filter):
        filter_fn = node.predicate
        node = node.child
    if not isinstance(node, Join):
        return None
    if not (isinstance(node.build, Scan) and isinstance(node.probe, Scan)):
        return None
    if agg is None and not sort_keys and filter_fn is None and project is None:
        return None
    build, probe = node.build.relation, node.probe.relation
    if len(build) == 0 or len(probe) == 0:
        return None  # degenerate inputs keep the generic path's exact semantics
    return (FusedSpec(node.key, filter_fn, sort_keys, agg, project),
            build, probe)


# ---------------------------------------------------------------------------
# Column view: late materialization inside the device program
# ---------------------------------------------------------------------------

def _decoders(sigs, dicts, refs):
    """Per-column device decode closures from static layout signatures plus
    the runtime dictionary/reference-point inputs.  ``None`` marks a plain
    (raw-layout) column — no decode work ever runs for it."""
    out = {}
    for name, (enc, _cdt, ldt) in sigs:
        if enc == "raw":
            out[name] = None
        elif enc == "for":
            out[name] = (lambda a, _l=ldt, _r=refs[name]:
                         decode_device(a, "for", _l, ref=_r))
        else:
            out[name] = (lambda a, _l=ldt, _d=dicts[name]:
                         decode_device(a, "dict", _l, dict_values=_d))
    return out


class _JoinView:
    """Column access over the joined index space; gathers on first touch only.

    Presents the joined schema (probe columns under their own names, build
    columns as ``b_<name>``, probe's key column under the join key).  Filter
    predicates receive this view — numpy-style expressions evaluate on its
    device tensors.

    Packed columns are stored as narrow codes: the gather moves code-width
    bytes and the decode to logical values runs *after* it, so the expensive
    data movement inside the program happens at packed width and consumers
    of the view still see exact logical values (the decode-at-fetch rule).
    """

    def __init__(self, bcols, pcols, key, build_idx, probe_idx,
                 bdec=None, pdec=None):
        self._bcols = bcols
        self._pcols = pcols
        self._key = key
        self._bidx = build_idx
        self._pidx = probe_idx
        self._bdec = bdec or {}
        self._pdec = pdec or {}
        self._cache: Dict[str, torch.Tensor] = {}

    def names(self):
        out = list(self._pcols)
        out += [f"b_{n}" for n in self._bcols
                if n != self._key and f"b_{n}" not in out]
        return out

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._cache:
            # build side resolves first: when a probe column is literally
            # named b_<x> and the build side has x, the engine's join
            # (a dict merge that assigns build columns last) serves the
            # BUILD column under that name — the view must agree
            if (name.startswith("b_") and name[2:] in self._bcols
                    and name[2:] != self._key):
                col = take(self._bcols[name[2:]], self._bidx)
                dec = self._bdec.get(name[2:])
            elif name in self._pcols:
                col = take(self._pcols[name], self._pidx)
                dec = self._pdec.get(name)
            else:
                raise KeyError(name)
            self._cache[name] = col if dec is None else dec(col)
        return self._cache[name]


# ---------------------------------------------------------------------------
# Program construction + shape-bucketed program cache
# ---------------------------------------------------------------------------

class _PipelineCache:
    """Program cache keyed on the bucketed shape signature.

    It (a) builds each program closure once per shape and (b) exposes
    hit/miss counters that tests use to prove shape bucketing prevents
    per-query churn.  A program's first call on a CUDA device also pays
    one-off costs (loading the kernel library, the allocator's first
    blocks), which is why a fresh entry stays "cold" until a call has
    completed.

    Thread-safe: concurrent serving sessions share this cache, so lookups,
    counter updates and inserts happen under one lock.  ``builder()`` runs
    inside the lock — it only constructs the program closure (cheap), and
    holding the lock guarantees two racing queries of the same shape get
    the SAME program object, so cache-miss accounting stays exact (the
    warm/cold feedback gate keys off it)."""

    def __init__(self):
        # key -> [program, ready]; ready flips once a call has completed,
        # i.e. its one-off first-call costs are definitely paid
        self._programs: Dict[Tuple, list] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple, builder: Callable[[], Callable]
            ) -> Tuple[Callable, bool]:
        """Returns ``(program, fresh)``.  ``fresh`` means the next call may
        pay first-call costs — either this is the first request for the
        shape, or another thread inserted the program and is still inside
        its first call.  Fresh runs execute OUTSIDE the device dispatch
        queue and count as cache misses, so the executor's warm-feedback
        gate keeps their cold walls out of the runtime profile."""
        with self._lock:
            entry = self._programs.get(key)
            if entry is None:
                self.misses += 1
                entry = self._programs[key] = [builder(), False]
                return entry[0], True
            if not entry[1]:
                self.misses += 1  # first call still running somewhere: cold
                return entry[0], True
            self.hits += 1
            return entry[0], False

    def mark_ready(self, key: Tuple) -> None:
        """A call of this program completed: its first-call costs are
        paid."""
        with self._lock:
            entry = self._programs.get(key)
            if entry is not None:
                entry[1] = True

    def info(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "programs": len(self._programs)}

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self.hits = 0
            self.misses = 0


_CACHE = _PipelineCache()


def pipeline_cache_info() -> Dict[str, int]:
    return _CACHE.info()


def pipeline_cache_clear() -> None:
    _CACHE.clear()


class PredicateError(Exception):
    """A filter predicate could not be evaluated on the fused program's
    device tensors (it needs host numpy, or it returned a host array).  The
    executor answers it by running the plan on its generic walk, which
    evaluates the predicate on the host; every other error propagates."""


def _is_device_fault(exc: BaseException) -> bool:
    """CUDA errors and out-of-memory are faults of the device, never of a
    predicate, and must not be turned into a quiet fallback."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


def device_mask(fn: Callable, view, n: int,
                device: torch.device) -> torch.Tensor:
    """Evaluate a row-wise filter predicate over a device column view and
    return its ``[n]`` bool mask on ``device``; raises
    :class:`PredicateError` when the predicate cannot run there."""
    try:
        mask = fn(view)
    except Exception as exc:
        if _is_device_fault(exc):
            raise
        raise PredicateError(
            f"filter predicate cannot run on device tensors: {exc!r}") from exc
    if isinstance(mask, torch.Tensor):
        if mask.device != device:
            raise PredicateError("filter predicate left the device")
        return mask.to(torch.bool)
    if isinstance(mask, (bool, np.bool_)):
        return torch.full((n,), bool(mask), dtype=torch.bool, device=device)
    raise PredicateError(
        f"filter predicate returned a host {type(mask).__name__}, not a "
        f"device mask")


def _fill_max(dtype: torch.dtype):
    """The reference's sink value: the integer dtype's maximum, else +inf
    (bool is not an integer there either)."""
    if dtype.is_floating_point or dtype == torch.bool:
        return float("inf")
    return torch.iinfo(dtype).max


def _fill_min(dtype: torch.dtype):
    if dtype.is_floating_point or dtype == torch.bool:
        return float("-inf")
    return torch.iinfo(dtype).min


def _seed_slots(size: int, index: torch.Tensor, src: torch.Tensor,
                init: int) -> torch.Tensor:
    """``out = full(size, init); out[index] = src`` where every index below
    ``size - 1`` occurs at most once: the last slot absorbs every row that
    must not write and is sliced off by the caller, so which of them lands
    there does not matter.  A plain store, not the reference's scatter-max:
    with one atomic max per row, the millions of padding rows that pile
    onto the absorbing slot serialize on one address."""
    out = torch.full((size,), init, dtype=torch.int64, device=src.device)
    return out.scatter_(0, index, src)


def _join_sorted(bk, pk, n_build, n_probe, capacity):
    """General join core: sorted coordinate alignment (one device sort)."""
    B = bk.shape[0]
    P = pk.shape[0]
    dev = bk.device
    iota_b = torch.arange(B, device=dev)
    iota_p = torch.arange(P, device=dev)
    # bucket padding rows sort to the tail and can never match
    bk_m = torch.where(iota_b < n_build, bk, _I64_MAX)
    order = torch.argsort(bk_m, stable=True)
    sk = bk_m[order].contiguous()
    pk = pk.contiguous()
    left = torch.searchsorted(sk, pk)
    right = torch.searchsorted(sk, pk, right=True)
    counts = right - left
    # padded probe rows contribute nothing; a real probe key equal to the
    # int64 sentinel would false-match padded build rows, so it is
    # excluded (documented key-domain contract)
    counts = torch.where((iota_p < n_probe) & (pk != _I64_MAX), counts, 0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = ends[-1]
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    # expansion by scan, not binary search: scatter each matched probe row's
    # index at its start slot (starts of matched rows are distinct; the
    # extra slot `capacity` absorbs unmatched rows and rows that start past
    # the end), then forward-fill with a running max
    tgt = torch.where(counts > 0, torch.clamp(starts, max=capacity), capacity)
    seeded = _seed_slots(capacity + 1, tgt, iota_p, -1)[:capacity]
    probe_idx = torch.clamp(torch.cummax(seeded, 0).values, min=0)
    build_pos = left[probe_idx] + (slot - starts[probe_idx])
    build_idx = order[torch.clamp(build_pos, 0, B - 1)]
    valid = slot < total
    has_dup = torch.zeros((), dtype=torch.bool, device=dev)
    return build_idx, probe_idx, valid, total, has_dup


def _join_sorted_run(sk, pk, n_probe, capacity):
    """Join core over PRE-SORTED build runs, batched over partitions (the
    sharded path).

    ``sk`` is ``(P, B)``: each row one partition's build keys, sorted, with
    sentinel padding at the tail (:mod:`repro_torch.core.partition`), so
    alignment is a searchsorted probe over an already-ordered resident run
    — **no per-query device sort at all**.  ``pk`` is ``(P, Q)`` and
    ``n_probe`` the ``(P,)`` live probe rows of each partition.
    ``build_idx``/``probe_idx`` are ``(P, capacity)`` positions within
    their partition's row; ``total`` is each partition's match count.

    Two steps differ from the reference's per-shard body, with the same
    result: the running match ends come from ONE scan over all partitions
    minus each partition's base, and expansion finds each slot's probe row
    by a binary search of the slot over its partition's ends (the first row
    whose end passes the slot) where the reference scatters each row at
    its start and forward-fills with a running max.  Every valid slot gets
    the same row; the rest are masked.  On the card a scan along dim 1 of
    a few long rows is many times slower than either (torch's ``cummax``
    took 3.1 and its ``cumsum`` 1.5 of 6.3 ms of device time of Q-a at SF1
    over 8 partitions).
    """
    P, B = sk.shape
    Q = pk.shape[1]
    dev = sk.device
    left = torch.searchsorted(sk, pk)
    right = torch.searchsorted(sk, pk, right=True)
    # padded probe rows contribute nothing; a real probe key equal to the
    # int64 sentinel would false-match padded build rows, so it is
    # excluded (the same key-domain contract as the single-device core)
    live = torch.arange(Q, device=dev) < n_probe[:, None]
    counts = torch.where(live & (pk != _I64_MAX), right - left, 0)
    ends = torch.cumsum(counts.reshape(-1), 0).reshape(P, Q)
    base = torch.cat([ends.new_zeros(1), ends[:-1, -1]])
    ends = ends - base[:, None]
    starts = ends - counts
    total = ends[:, -1]
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    probe_idx = torch.clamp(
        torch.searchsorted(ends, slot.expand(P, capacity).contiguous(),
                           right=True), max=Q - 1)
    build_pos = (torch.gather(left, 1, probe_idx)
                 + (slot - torch.gather(starts, 1, probe_idx)))
    build_idx = torch.clamp(build_pos, 0, B - 1)
    valid = slot < total[:, None]
    return build_idx, probe_idx, valid, total


def _join_dense(bk, pk, n_build, n_probe, capacity, domain: int, kmin: int):
    """Dense-domain join core: the key IS a coordinate axis.

    When the build key domain is dense enough to materialize as an axis of
    length ``domain`` (a power-of-two bucket; ``kmin`` is the offset) and
    build keys are unique (PK-FK joins), alignment is direct scatter/gather
    addressing — NO device sort at all.  Uniqueness is *verified on device*
    and the flag rides back with the result fetch; the run loop re-runs on
    the sorted core if the optimistic choice was wrong.  Slot ``domain`` is
    the dead slot for rows that must not match (bucket padding /
    out-of-domain keys).

    The table build and probe are the radix join of
    :func:`~repro_torch.core.tensor_engine.radix_hash_probe_dispatch`: the
    in-domain codes ``bk0c``/``pk0c`` are exactly the int32 code-domain
    contract of its kernels, at any domain size on a CUDA device.  The
    per-operator :func:`~repro_torch.core.tensor_engine.tensor_join_device`
    runs it too.
    """
    B = bk.shape[0]
    P = pk.shape[0]
    dev = bk.device
    iota_b = torch.arange(B, device=dev)
    iota_p = torch.arange(P, device=dev)
    bk0 = bk - kmin
    b_live = iota_b < n_build
    bk0c = torch.where(b_live & (bk0 >= 0) & (bk0 < domain), bk0, domain)
    pk0 = pk - kmin
    p_live = (iota_p < n_probe) & (pk0 >= 0) & (pk0 < domain)
    pk0c = torch.where(p_live, pk0, domain)
    cnt_p, brow, has_dup = radix_hash_probe_dispatch(
        bk0c.to(torch.int32), pk0c.to(torch.int32), domain)
    matched = p_live & (cnt_p > 0)
    ends = torch.cumsum(matched.to(torch.int64), 0)
    total = ends[-1]
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    pos = torch.where(matched, torch.clamp(ends - 1, max=capacity - 1),
                      capacity)
    # matched rows own distinct slots ends - 1; the rest go to `capacity`
    probe_idx = _seed_slots(capacity + 1, pos, iota_p, 0)[:capacity]
    build_idx = torch.clamp(brow, min=0).to(torch.int64)[probe_idx]
    valid = slot < total
    return build_idx, probe_idx, valid, total, has_dup


def _build_program(spec: FusedSpec, key: str, capacity: int,
                   dense_domain: Optional[int] = None,
                   key_mode: str = "value",
                   bsig: Tuple = (), psig: Tuple = ()):
    """Program closure for one (fragment, capacity, bucket) cache entry.

    ``dense_domain`` (a power-of-two bucket) selects the sort-free
    coordinate join core; the domain offset ``kmin`` is a runtime input so
    drifting key ranges reuse the program.

    ``bsig``/``psig`` are the per-column layout signatures
    (:meth:`~repro_torch.core.codec_device.DeviceColumnLayout.signature`) of
    the packed inputs — the program closes over the codec *shape*;
    dictionaries and reference points stay runtime inputs.  ``key_mode``
    selects the join coordinate domain:

      * ``"value"`` — the key decodes to int64 values in-program (an
        elementwise op; the H2D transfer already happened at packed width);
      * ``"dict"``  — the build key is dictionary-encoded and the join runs
        *directly in the code domain*: build codes are the coordinates,
        probe values remap into the build dictionary with one device
        ``searchsorted`` (misses land on the dead slot), and the dense core
        operates over ``dense_domain ==`` the padded dictionary bucket.

    Every launch in the program is asynchronous; nothing in it synchronises
    with the host.  :func:`run_fused` fetches its outputs in one batched
    copy.
    """

    def program(bcols: Dict[str, torch.Tensor], pcols: Dict[str, torch.Tensor],
                bdicts, pdicts, brefs, prefs, n_build, n_probe, kmin):
        bdec = _decoders(bsig, bdicts, brefs)
        pdec = _decoders(psig, pdicts, prefs)
        dev = pcols[key].device
        if key_mode == "dict":
            # code-domain join: build codes ARE the coordinates; the probe
            # side remaps its logical key values into the build dictionary
            # (padded with repeats of the last value — a left searchsorted
            # still returns the true first occurrence; see pad_dictionary)
            bk = bcols[key].to(torch.int64)
            pk_raw = pcols[key]
            pk_vals = (pk_raw if pdec.get(key) is None
                       else pdec[key](pk_raw)).to(torch.int64).contiguous()
            bdict = bdicts[key].to(torch.int64).contiguous()
            dbkt = bdict.shape[0]
            pos = torch.searchsorted(bdict, pk_vals)
            posc = torch.clamp(pos, 0, dbkt - 1)
            hit = bdict[posc] == pk_vals
            pk = torch.where(hit, posc, dense_domain).to(torch.int64)
        else:
            # join coordinates are int64 (same coercion as tensor_join); the
            # view/output below serves the ORIGINAL key column — dtype and
            # values of result columns never depend on fusion
            bk_raw, pk_raw = bcols[key], pcols[key]
            bk = (bk_raw if bdec.get(key) is None
                  else bdec[key](bk_raw)).to(torch.int64)
            pk = (pk_raw if pdec.get(key) is None
                  else pdec[key](pk_raw)).to(torch.int64)
        if dense_domain is not None:
            build_idx, probe_idx, valid, total, has_dup = _join_dense(
                bk, pk, n_build, n_probe, capacity, dense_domain, kmin)
        else:
            build_idx, probe_idx, valid, total, has_dup = _join_sorted(
                bk, pk, n_build, n_probe, capacity)

        view = _JoinView(bcols, pcols, key, build_idx, probe_idx, bdec, pdec)
        if spec.filter_fn is not None:
            valid = valid & device_mask(spec.filter_fn, view, capacity, dev)

        perm = None
        if spec.sort_keys:
            # ONE multi-operand lexicographic device sort: key axes stay
            # separate operands (no linearization into a composite scalar).
            # Invalid rows sink by pinning their most-significant key to the
            # dtype maximum — their relative position among real max-key
            # rows is irrelevant because only valid rows survive
            # materialization.
            # unsigned keys map to signed ones of the same order first:
            # CUDA has no ``where`` for uint16/32/64
            keys0 = [_order_key(view[k]) for k in spec.sort_keys]
            msk = keys0[0]
            operands = ([torch.where(valid, msk, _fill_max(msk.dtype))]
                        + keys0[1:])
            perm = _lex_perm(operands, capacity, dev)

        if spec.agg is not None:
            col_name, fn = spec.agg
            col = view[col_name]
            v = valid if perm is None else valid[perm]
            c = col if perm is None else take(col, perm)
            # integer columns reduce in int64 (exact, matches the host path
            # bit-for-bit — f64 would lose integer sums past 2^53)
            if fn == "sum":
                scalar = torch.where(v, c, torch.zeros((), dtype=c.dtype,
                                                       device=dev)).sum()
            elif fn == "count":
                scalar = v.sum().to(torch.int64)
            elif fn == "min":
                scalar = torch.where(v, c, _fill_max(c.dtype)).min()
            elif fn == "max":
                scalar = torch.where(v, c, _fill_min(c.dtype)).max()
            else:
                raise ValueError(fn)
            # agg_n rides the fetch so run_fused can reject min/max over an
            # empty result (the fill value is not a legitimate answer) the
            # way the host path's numpy reduction does
            return {"total": total, "has_dup": has_dup, "scalar": scalar,
                    "agg_n": v.sum()}

        # relation root (sort is the last stage): gather the output schema
        # through the sorted indices — the only payload gathers in the
        # whole pipeline, and they happen once, on device.  A projected
        # root gathers (and later fetches) only its declared subset.
        out_names = view.names() if spec.project is None else spec.project
        out_cols = {name: (view[name] if perm is None
                           else take(view[name], perm))
                    for name in out_names}
        out_valid = valid if perm is None else valid[perm]
        return {"total": total, "has_dup": has_dup, "cols": out_cols,
                "valid": out_valid}

    return program


# ---------------------------------------------------------------------------
# Sharded program: the partition-parallel fragment over logical lanes
# ---------------------------------------------------------------------------

def sharded_supported(spec: FusedSpec, build: Relation,
                      probe: Relation) -> bool:
    """Host-side eligibility of a fragment for partition-parallel execution.

    The sharded path merges per-partition results with device-side
    combines (psum/pmin/pmax over the mesh axis), so only scalar
    AGGREGATE roots qualify — a relation root would need a global merge
    that re-serializes the partitions.  Bit-for-bit parity with the
    single-device program is part of the contract, which admits exactly
    the order-independent reductions: ``count`` always; ``min``/``max``
    always (exact for floats too); ``sum`` only over integer columns —
    integer addition is associative even under wraparound, while a float
    psum of per-partition partials reassociates the single program's
    reduction order.  Join keys must be integers (the partition hash and
    the sentinel padding contract are int64).  A fragment's sort stage is
    irrelevant under these aggregates and is skipped per shard.
    """
    if spec.agg is None:
        return False
    key = spec.join_key
    for rel in (build, probe):
        if not isinstance(rel, Relation) or key not in rel.names:
            return False
        if not np.issubdtype(rel[key].dtype, np.integer):
            return False
    col, fn = spec.agg
    if fn == "count":
        return True
    # the _JoinView naming contract: build wins b_<x> collisions
    if col.startswith("b_") and col[2:] in build.names and col[2:] != key:
        dtype = build[col[2:]].dtype
    elif col in probe.names:
        dtype = probe[col].dtype
    else:
        return False
    if fn in ("min", "max"):
        return True
    return fn == "sum" and bool(np.issubdtype(dtype, np.integer))


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _partition_scalar(fn: str, c: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """One reduction over every partition's rows that gives the bits of the
    reference's per-partition aggregates combined by psum/pmin/pmax.

    Integer sums run in int64, which is the reference's accumulator (its
    ``sum`` of a narrower integer widens to int64, of an unsigned one to
    uint64): addition modulo 2^64 is associative, so one sum equals the
    sum of the partials, and an unsigned sum comes back as a uint64 view
    of the same bits.  Integer min/max run on :func:`_order_key`'s signed
    key of the same order (CUDA has no ``where`` or comparison for
    uint16/32/64); floats and bool reduce as the single-device program
    does."""
    if fn == "sum":
        wide = (c.view(torch.int64) if c.dtype == torch.uint64
                else _order_key(c).to(torch.int64))
        out = torch.where(valid, wide, 0).sum()
        return out.view(torch.uint64) if c.dtype in _UNSIGNED else out
    if c.dtype.is_floating_point or c.dtype == torch.bool:
        fill = _fill_max(c.dtype) if fn == "min" else _fill_min(c.dtype)
        masked = torch.where(valid, c, fill)
        return masked.min() if fn == "min" else masked.max()
    key = _order_key(c)
    info = torch.iinfo(key.dtype)
    if fn == "min":
        out = torch.where(valid, key, info.max).min()
    elif fn == "max":
        out = torch.where(valid, key, info.min).max()
    else:
        raise ValueError(fn)
    if c.dtype == torch.uint64:
        out = (out ^ torch.iinfo(torch.int64).min).view(torch.uint64)
    return out


def _build_sharded_program(spec: FusedSpec, key: str, num_parts: int,
                           capacity: int, bsig: Tuple = (),
                           psig: Tuple = ()):
    """Program closure for one sharded (fragment, partitions, capacity)
    cache entry: the reference's per-shard fragment body, run for all
    ``num_parts`` partitions at once over ``(num_parts, bucket)`` tensors,
    with its device-side combines, so the host still fetches ONE result
    per query.

    ``max_part_total`` (the largest single partition's match count) rides
    the fetch next to the summed total so the run loop can verify its
    optimistic per-partition capacity without a second sync.

    The join runs per partition row (:func:`_join_sorted_run`); the
    gathers run on the flattened partitions, each row's positions offset
    by ``p * bucket``, so the column view, the filter mask and the
    dictionary/FOR decoders work on 1-D columns as in the single-device
    program.  Payload columns arrive as packed codes (``bsig``/``psig``
    carry the layout signatures); dictionaries serve every partition.  The
    join key stays logical int64 (the sentinel-padding contract).
    """
    col_name, fn = spec.agg

    def program(bcols, pcols, bdicts, pdicts, brefs, prefs,
                n_build, n_probe):
        bdec = _decoders(bsig, bdicts, brefs)
        pdec = _decoders(psig, pdicts, prefs)
        del n_build  # build padding is sentinel-keyed; no live-row mask
        sk = bcols[key].to(torch.int64)
        pk = pcols[key].to(torch.int64)
        dev = pk.device
        build_idx, probe_idx, valid, total = _join_sorted_run(
            sk, pk, n_probe, capacity)
        part = torch.arange(num_parts, device=dev)[:, None]
        view = _JoinView({k: v.reshape(-1) for k, v in bcols.items()},
                         {k: v.reshape(-1) for k, v in pcols.items()}, key,
                         (build_idx + part * sk.shape[1]).reshape(-1),
                         (probe_idx + part * pk.shape[1]).reshape(-1),
                         bdec, pdec)
        valid = valid.reshape(-1)
        if spec.filter_fn is not None:
            valid = valid & device_mask(spec.filter_fn, view,
                                        num_parts * capacity, dev)
        # sort stage intentionally skipped: the supported aggregates are
        # order-independent (see sharded_supported)
        if fn == "count":
            scalar = valid.sum()
        else:
            scalar = _partition_scalar(fn, view[col_name], valid)
        return {"total": total.sum(), "max_part_total": total.max(),
                "scalar": scalar, "agg_n": valid.sum()}

    return program


def _fetch(out: Dict) -> Dict:
    """THE host sync of a query: every output of the program in one batched
    device→host copy and one synchronise."""
    names = [k for k in out if k != "cols"]
    cols = out.get("cols", {})
    arrays = to_host([out[k] for k in names] + list(cols.values()))
    fetched = dict(zip(names, arrays[:len(names)]))
    if "cols" in out:
        fetched["cols"] = dict(zip(cols, arrays[len(names):]))
    return fetched


# ---------------------------------------------------------------------------
# Run loop
# ---------------------------------------------------------------------------

# The device is a serially-shared resource: concurrent serving sessions
# funnel fused-program launches through the broker's DeviceQueue (a typed
# DeviceLease per dispatch), so a query's device phase runs at full speed
# instead of time-slicing against its neighbours.  Latency becomes queue
# wait + execution — the wait is accounted in OpMetrics.queue_wait_s and
# excluded from the runtime profile's execution-cost observations.  Queued
# dispatches of the SAME program shape (lease batch_key = the pipeline cache
# key) coalesce into one micro-batched admission group; the programs are
# identical over independent inputs, so coalescing changes scheduling only,
# never results.  CUDA launches are asynchronous, so the lease is held until
# the result fetch has returned: releasing it at launch time would teach the
# broker launch times instead of run times.


def _host_plan(build: Relation, probe: Relation, key: str):
    """Host-side planning from the numpy inputs — free of device traffic.

    Returns ``(capacity, dense_domain, kmin)``: an optimistic capacity bucket
    from the cached key-cardinality sketch (:func:`repro_torch.core.
    table_cache.key_stats` — repeated queries do not re-sample), and — when
    the build key domain is dense enough to materialize as a coordinate axis
    and the sample predicts unique keys — the power-of-two domain bucket for
    the sort-free dense join core.  Both predictions are *verified on
    device* (overflow / has_dup piggyback on the result fetch), so a wrong
    guess costs one retry, never a wrong answer.
    """
    stats = key_stats(build, key)
    capacity = capacity_bucket(int(len(probe) * stats.dup))
    return (capacity, *dense_domain(stats))


def run_fused(spec: FusedSpec, build: Relation, probe: Relation,
              decision_reason: str = "", broker=None,
              shards: Optional[int] = None,
              guard=None, device=None) -> Tuple[object, OpMetrics]:
    """Execute a fused fragment; returns (Relation | float, OpMetrics).

    Happy path: one program launch sequence + one batched device→host fetch.
    Capacity overflow (optimistic bucket too small) re-runs once at the exact
    bucket; both programs stay cached for subsequent queries.

    Device dispatch acquires a :class:`~repro_torch.core.resource_broker.
    DeviceLease` from ``broker`` (the process-wide default broker when none
    is passed — one shared queue per physical device) and holds it until the
    fetch has returned.

    ``shards=N`` (N >= 2) requests partition-parallel execution over N
    logical lanes of the device: hash co-partition both sides by the join
    key, run the fragment for every partition in one batched program, and
    combine per-partition aggregates on device — still ≤ 1 device→host
    sync.  The request silently degrades to the single-device program when
    the fragment is not :func:`sharded_supported` (metrics then report
    ``devices=1``); dispatch holds a gang lease over one broker lane per
    partition.

    ``guard`` is an optional :class:`~repro_torch.core.guards.ExecutionGuard`:
    a capacity overflow — the device reporting the ACTUAL join fan-out —
    is fed to ``guard.observe_fragment`` before the retry, which may raise
    :class:`~repro_torch.core.guards.SwitchPoint` to abandon the retry loop.

    ``device`` is the CUDA device unless the caller names another.
    """
    dev = resolve_device(device)
    if broker is None:
        from .resource_broker import default_broker
        broker = default_broker()
    if shards is not None and int(shards) > 1:
        num_parts = min(int(shards), available_partitions())
        if num_parts > 1 and sharded_supported(spec, build, probe):
            return _run_fused_sharded(spec, build, probe, num_parts,
                                      decision_reason, broker, dev)
    n_build, n_probe = len(build), len(probe)
    b_bucket = capacity_bucket(n_build)
    p_bucket = capacity_bucket(n_probe)
    syncs = 0
    queue_wait = 0.0
    any_fresh = False
    batched = False
    with Timer() as t:
        # host planning is part of the query's wall time (the per-op
        # baseline pays for its planning inside its timers too)
        capacity, dense_domain, kmin = _host_plan(build, probe, spec.join_key)
        layouts_b, up_b, log_b = get_device_layouts(build, b_bucket, dev)
        layouts_p, up_p, log_p = get_device_layouts(probe, p_bucket, dev)
        bcols = {k: dc.codes for k, dc in layouts_b.items()}
        pcols = {k: dc.codes for k, dc in layouts_p.items()}
        bdicts = {k: dc.dict_values for k, dc in layouts_b.items()
                  if dc.dict_values is not None}
        pdicts = {k: dc.dict_values for k, dc in layouts_p.items()
                  if dc.dict_values is not None}
        brefs = {k: dc.layout.ref for k, dc in layouts_b.items()
                 if dc.encoding == "for"}
        prefs = {k: dc.layout.ref for k, dc in layouts_p.items()
                 if dc.encoding == "for"}
        bsig = tuple(sorted((k, dc.layout.signature())
                            for k, dc in layouts_b.items()))
        psig = tuple(sorted((k, dc.layout.signature())
                            for k, dc in layouts_p.items()))
        # Dictionary-encoded build key + sampled-unique keys: join in the
        # code domain — the dense core over the padded dictionary bucket,
        # even when the VALUE domain is far too wide/sparse for it.  A
        # wrong uniqueness guess is caught on device (has_dup) and retried
        # on the sorted value core, same as the value-dense path.
        key_mode = "value"
        bkey = layouts_b[spec.join_key]
        if bkey.encoding == "dict":
            stats = key_stats(build, spec.join_key)
            if stats.dup == 1.0 and stats.n:
                key_mode = "dict"
                dense_domain = dict_bucket(bkey.layout.card)
                kmin = 0
        while True:
            cache_key = (spec.cache_signature(), capacity, b_bucket,
                         p_bucket, dense_domain, key_mode, bsig, psig,
                         dev.type)
            prog, fresh = _CACHE.get(
                cache_key,
                lambda: _build_program(spec, spec.join_key, capacity,
                                       dense_domain, key_mode, bsig, psig))
            # a FRESH program's first call pays one-off costs; running it
            # outside the queue keeps one novel shape from stalling every
            # other query's device phase (cold runs never feed the runtime
            # profile anyway)
            any_fresh = any_fresh or fresh
            lease = None
            if not fresh:
                lease = broker.device_lease(batch_key=("fused", cache_key))
                queue_wait += lease.wait_s
            try:
                out = prog(bcols, pcols, bdicts, pdicts, brefs, prefs,
                           n_build, n_probe, kmin)
                fetched = _fetch(out)  # THE host sync of the query
            finally:
                if lease is not None:
                    lease.release()
                    # read AFTER the run: `batched` is live — a solo lease
                    # becomes batched when a same-shape arrival joins its
                    # in-flight round
                    batched = batched or lease.batched
            if fresh:
                _CACHE.mark_ready(cache_key)
            syncs += 1
            total = int(fetched["total"])
            if dense_domain is not None and bool(fetched["has_dup"]):
                # optimistic unique-key guess was wrong: fall back to the
                # sorted core over decoded int64 values (code-domain joins
                # included — the sorted core's sentinel contract is int64)
                dense_domain = None
                key_mode = "value"
                kmin = 0
                continue
            if total <= capacity:
                break
            if guard is not None:
                # the overflow IS the observed fan-out: let the execution-
                # time guard re-check the fragment decision before paying
                # the retry dispatch (raises SwitchPoint to abandon)
                guard.observe_fragment(total, capacity)
            capacity = capacity_bucket(total)  # rare: bucket overflowed
        if spec.agg is not None:
            if spec.agg[1] in ("min", "max") and int(fetched["agg_n"]) == 0:
                raise ValueError(
                    f"{spec.agg[1]} over an empty result has no identity")
            result = float(fetched["scalar"])
            rows_out = 1
        else:
            keep = np.nonzero(fetched["valid"])[0]
            result = Relation({k: v[keep] for k, v in fetched["cols"].items()})
            rows_out = len(result)
    metrics = OpMetrics(
        op="fused_pipeline",
        path="tensor",
        rows_in=n_build + n_probe,
        rows_out=rows_out,
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=(b_bucket + p_bucket) * 8 * 3
        + capacity * 8 * (3 + len(spec.sort_keys)),
        decision_reason=decision_reason,
        host_syncs=syncs,
        h2d_bytes=up_b + up_p,
        h2d_bytes_logical=log_b + log_p,
        queue_wait_s=queue_wait,
        compiled=any_fresh,
        batched=batched,
    )
    return result, metrics


# Verified per-partition capacities by (fragment, partitions, key-column
# tokens): content-addressed, so a mutated table simply misses and re-plans.
# Bounded as a backstop; overflow costs at most one extra retry per entry.
_CAP_HINTS: Dict[tuple, int] = {}
_CAP_HINT_LOCK = threading.Lock()
_CAP_HINTS_CAP = 512


def _run_fused_sharded(spec: FusedSpec, build: Relation, probe: Relation,
                       num_parts: int, decision_reason: str, broker,
                       dev: torch.device) -> Tuple[float, OpMetrics]:
    """Partition-parallel run loop: cached partitioned layouts in, ONE gang
    dispatch over ``num_parts`` broker lanes, ONE batched fetch out.

    The per-partition capacity is optimistic — the critical partition's
    probe fill times the sampled duplication factor, with skew slack — and
    verified on device: ``max_part_total`` rides the single result fetch,
    a wrong guess costs one retry at the exact bucket, never a wrong
    answer (the same discipline as the single-device run loop's overflow
    and dense retries).
    """
    n_build, n_probe = len(build), len(probe)
    syncs = 0
    queue_wait = 0.0
    any_fresh = False
    batched = False
    broker.ensure_lanes(num_parts)
    with Timer() as t:
        stats = key_stats(build, spec.join_key)
        (bcols, counts_b_dev, counts_b, bucket_b, up_b, log_b, b_lay,
         bdicts) = get_partitioned_columns(build, spec.join_key, num_parts,
                                           sort_within=True, device=dev)
        (pcols, counts_p_dev, counts_p, bucket_p, up_p, log_p, p_lay,
         pdicts) = get_partitioned_columns(probe, spec.join_key, num_parts,
                                           sort_within=False, device=dev)
        brefs = {k: lay.ref for k, lay in b_lay.items()
                 if lay.encoding == "for"}
        prefs = {k: lay.ref for k, lay in p_lay.items()
                 if lay.encoding == "for"}
        bsig = tuple(sorted((k, lay.signature()) for k, lay in b_lay.items()))
        psig = tuple(sorted((k, lay.signature()) for k, lay in p_lay.items()))
        est_part_out = int(max(1, int(counts_p.max())) * stats.dup)
        capacity = partition_bucket(int(est_part_out * 1.25))
        # A verified-capacity hint from an earlier run of this fragment over
        # the same data: the optimistic estimate is recomputed per call, so
        # without the hint a query whose critical partition overflows it
        # would pay the overflow retry (a second dispatch + fetch) on EVERY
        # warm serving query, not just the first.
        hint_key = (spec.cache_signature(), num_parts,
                    column_token(build[spec.join_key]),
                    column_token(probe[spec.join_key]))
        with _CAP_HINT_LOCK:
            capacity = max(capacity, _CAP_HINTS.get(hint_key, 0))
        while True:
            cache_key = ("sharded", spec.cache_signature(), num_parts,
                         capacity, bucket_b, bucket_p, bsig, psig, dev.type)
            prog, fresh = _CACHE.get(
                cache_key,
                lambda: _build_sharded_program(spec, spec.join_key,
                                               num_parts, capacity,
                                               bsig, psig))
            any_fresh = any_fresh or fresh
            # ALWAYS under the gang lease, a fresh program's first call
            # included: a gang holds every lane, lane 0 among them, so a
            # sharded run never overlaps a single-lane dispatch
            lease = broker.device_lease(lanes=num_parts)
            queue_wait += lease.wait_s
            try:
                out = prog(bcols, pcols, bdicts, pdicts, brefs, prefs,
                           counts_b_dev, counts_p_dev)
                fetched = _fetch(out)  # THE host sync of the query
            finally:
                lease.release()
                batched = batched or lease.batched
            if fresh:
                _CACHE.mark_ready(cache_key)
            syncs += 1
            max_part = int(fetched["max_part_total"])
            if max_part <= capacity:
                # remember the verified minimal bucket (max() keeps it from
                # ever shrinking a future optimistic estimate)
                with _CAP_HINT_LOCK:
                    if len(_CAP_HINTS) >= _CAP_HINTS_CAP:
                        _CAP_HINTS.clear()
                    _CAP_HINTS[hint_key] = max(
                        _CAP_HINTS.get(hint_key, 0),
                        partition_bucket(max_part))
                break
            capacity = partition_bucket(max_part)  # rare: skewed overflow
        if spec.agg[1] in ("min", "max") and int(fetched["agg_n"]) == 0:
            raise ValueError(
                f"{spec.agg[1]} over an empty result has no identity")
        result = float(fetched["scalar"])
    metrics = OpMetrics(
        op="fused_pipeline",
        path="tensor",
        rows_in=n_build + n_probe,
        rows_out=1,
        wall_s=t.elapsed,
        spill=SpillAccount(),
        peak_working_set_bytes=num_parts * (bucket_b + bucket_p) * 8 * 3
        + num_parts * capacity * 8 * 3,
        decision_reason=decision_reason,
        host_syncs=syncs,
        h2d_bytes=up_b + up_p,
        h2d_bytes_logical=log_b + log_p,
        queue_wait_s=queue_wait,
        compiled=any_fresh,
        batched=batched,
        devices=num_parts,
    )
    return result, metrics
