"""The program's own spans in a traced run: what the readers of the
span metrics read, and the steps of each query laid on the device trace.

``repro_torch.core.metrics`` records a span at each of its layers'
boundaries (``query``, ``plan``, ``decide``, ``prepare``, ``lease_wait``,
``lease_hold``, ``launch``, ``fetch``, ``pin``, ``finish``) while its
recorder is on, and the recorder is on while a ``torch.profiler`` session
records in the process.  A ``--trace 1`` run profiles its window, so the
window's queries leave their spans in the program, and :func:`of` takes
them, once a run.  Each span has ``name``, ``query`` (the id of its
query's root span), ``id``, ``parent``, ``thread``, ``t0_ns``, ``t1_ns``
(``time.perf_counter_ns()``, the clock of the benchmark's own records)
and ``attrs``.

A program without the recorder leaves none, and every reader of a span
metric then returns None.

Beside the readers: :func:`coverage` (how much of each query its steps
account for, and how much of the benchmark's record of it the program's
root span covers) and :func:`traced_gaps` (the trace's idle gaps, each
label followed by the program span that overlaps the gap most, on a clock
anchored at both ends of the window).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

#: the program's module that holds the recorder
RECORDER = "repro_torch.core.metrics"
#: the steps a query's root span is made of, each a direct child of it
STEPS = ("plan", "decide", "prepare", "lease_wait", "lease_hold", "finish")


def of(run) -> list:
    """The spans of the queries that started in the run's window.

    ``run.spans`` where the run holds them; else what the program's
    recorder handed over (``stop_spans()``), kept on the run for the next
    reader."""
    got = getattr(run, "spans", None)
    if got is None:
        stop = getattr(sys.modules.get(RECORDER), "stop_spans", None)
        got = list(stop()) if stop is not None else []
        start = int(run.window_start * 1e9)
        roots = {s.id for s in got if s.parent is None and s.t0_ns >= start}
        got = [s for s in got if s.query in roots]
        run.spans = got
    return got


def answered(run) -> Dict[int, list]:
    """``{query id: its spans}`` of each query whose root span finished
    without an error."""
    spans = of(run)
    out: Dict[int, list] = {s.id: [] for s in spans
                            if s.parent is None and s.name == "query"
                            and "error" not in s.attrs}
    for s in spans:
        if s.query in out:
            out[s.query].append(s)
    return out


def ms(s) -> float:
    return (s.t1_ns - s.t0_ns) / 1e6


def per_query(run, names, value=ms) -> Optional[float]:
    """Mean over the answered queries of the sum of ``value`` over each
    query's spans named in ``names`` (0 for a query with none); None where
    no query left spans."""
    qs = answered(run)
    if not qs:
        return None
    return sum(value(s) for spans in qs.values() for s in spans
               if s.name in names) / len(qs)


def coverage(run) -> Optional[dict]:
    """How the program's spans account for the answered queries.

    ``steps_share``: each query's :data:`STEPS` (its root's direct
    children) over its root span, mean and least.  ``root_in_record``: the
    share of the benchmark's answered records that hold a root span inside
    their ``[t0, t1]``; ``root_cover``: that span over the record, mean."""
    qs = answered(run)
    if not qs:
        return None
    shares = []
    roots = []
    for qid, spans in qs.items():
        root = next(s for s in spans if s.id == qid)
        roots.append(root)
        total = root.t1_ns - root.t0_ns
        steps = sum(s.t1_ns - s.t0_ns for s in spans
                    if s.parent == qid and s.name in STEPS)
        shares.append(steps / total if total > 0 else 1.0)
    covers = []
    recs = run.answered()
    for rec in recs:
        lo, hi = int(rec.t0 * 1e9), int(rec.t1 * 1e9)
        inside = [r for r in roots if r.t0_ns >= lo and r.t1_ns <= hi]
        if inside and hi > lo:
            best = max(inside, key=lambda r: r.t1_ns - r.t0_ns)
            covers.append((best.t1_ns - best.t0_ns) / (hi - lo))
    return {"steps_share": sum(shares) / len(shares),
            "steps_share_min": min(shares),
            "root_in_record": len(covers) / len(recs) if recs else 0.0,
            "root_cover": sum(covers) / len(covers) if covers else 0.0}


def group_tally(run) -> Dict[int, int]:
    """How many of the answered queries' leases ran in groups of each
    size (``lease_hold``'s ``group``)."""
    out: Dict[int, int] = {}
    for spans in answered(run).values():
        for s in spans:
            if s.name == "lease_hold":
                g = s.attrs.get("group", 1)
                out[g] = out.get(g, 0) + 1
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# The spans on the device trace
# ---------------------------------------------------------------------------

def clock(lo_ns: int, hi_ns: int, opened: float, closed: float):
    """``(to_trace, skew_us)``: ``to_trace(t_ns)`` maps a
    ``perf_counter_ns`` reading onto the profiler's clock, linearly between
    the window span's opening (``lo_ns``, read as ``opened`` seconds on the
    host clock) and its close (``hi_ns``, ``closed``); ``skew_us`` is what
    mapping by the opening alone would be off by at the close."""
    o_ns = opened * 1e9
    length = (closed - opened) * 1e9
    rate = (hi_ns - lo_ns) / length if length > 0 else 1.0

    def to_trace(t_ns):
        return int(lo_ns + (t_ns - o_ns) * rate)

    return to_trace, ((hi_ns - lo_ns) - length) / 1e3


def _label(spans, by_id, s: int, e: int, to_trace) -> Optional[str]:
    """The innermost program span overlapping ``[s, e)`` most, as
    ``parent/name``."""
    best, best_key = None, None
    for sp in spans:
        ov = min(to_trace(sp.t1_ns), e) - max(to_trace(sp.t0_ns), s)
        if ov <= 0:
            continue
        depth, p = 0, sp.parent
        while p is not None and p in by_id:
            depth, p = depth + 1, by_id[p].parent
        key = (ov, depth)
        if best_key is None or key > best_key:
            best, best_key = sp, key
    if best is None:
        return None
    parent = by_id.get(best.parent)
    return f"{parent.name}/{best.name}" if parent is not None else best.name


def traced_gaps(events, cards: List[int], queries, spans, opened: float,
                closed: float):
    """``(gaps, skew_us)``: the window's longest idle gaps, as
    ``portbench.trace.reduce`` names them, each label followed by
    ``[parent/name]`` of the program span that overlaps the gap most.

    ``events`` are the trace's ``(name, is_device, card, start_ns,
    end_ns)`` (``portbench.trace._raw``), ``queries`` the benchmark's
    ``(name, t0, t1)`` records and ``opened``/``closed`` the host clock's
    readings as the window span opened and closed."""
    from . import trace as tr

    window = [ev for ev in events if ev[0] == tr.WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    lo, hi = window[0][3], window[0][4]
    shift = lo - int(opened * 1e9)
    recs = tr._Spans([(n, int(a * 1e9) + shift, int(b * 1e9) + shift)
                      for n, a, b in queries])
    host = tr._Spans([(n, s, e) for n, dev, _, s, e in events
                      if not dev and n != tr.WINDOW_SPAN])
    per_card: Dict[int, list] = {c: [] for c in cards}
    for name, dev, card, s, e in events:
        if dev and card in per_card:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                per_card[card].append((s, e))
    gaps = []
    for card, iv in per_card.items():
        edges = [lo] + [x for se in tr._union(iv) for x in se] + [hi]
        for i in range(0, len(edges), 2):
            if edges[i + 1] > edges[i]:
                gaps.append((edges[i + 1] - edges[i], edges[i],
                             edges[i + 1], card))
    gaps.sort(reverse=True)
    to_trace, skew_us = clock(lo, hi, opened, closed)
    by_id = {sp.id: sp for sp in spans}
    named = []
    for length, s, e, card in gaps[:tr.TOP]:
        label = tr._name_gap(s, e, host, recs)
        if len(cards) > 1:
            label = f"cuda:{card} {label}"
        step = _label(spans, by_id, s, e, to_trace)
        if step is not None:
            label = f"{label} [{step}]"
        named.append((label, length / 1e9))
    return named, skew_us
