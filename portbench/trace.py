"""The traced run's reduction: a ``torch.profiler`` session to busy time,
idle gaps and kernel times.

The benchmark profiles the whole measured window of a ``--trace 1`` run
(CPU and CUDA activity) inside one ``record_function`` span on its main
thread, :data:`WINDOW_SPAN`.  The profiler records the operators of the
thread that started it only, and the CUDA runtime's calls of every
thread; so the queries' own times come from the benchmark's records,
placed on the trace's clock by the window span's start.  From the trace
it takes:

* each card's busy time: the union of its device operations (kernels,
  copies, fills), so overlapping streams are not counted twice;
* each kernel's device time, summed by name;
* the idle gaps of each card, each named by the query in flight that
  overlapped it most, how many were in flight, and the host call that
  overlapped it most;
* the counts of kernels launched on the host and of kernels traced on the
  device: the card's profiler has been seen to drop device events, and the
  two counts then differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

#: the span around the whole traced window, on the benchmark's main thread
WINDOW_SPAN = "portbench_window"
#: host calls that launch one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
TOP = 10


@dataclasses.dataclass
class Trace:
    """What a traced window held, times in seconds."""

    window_s: float
    cards: int
    busy_s: float                      # averaged over the cards
    kernel_s: Dict[str, float]         # device time by operation name
    idle_gaps: List[Tuple[str, float]]  # longest first
    launches: int                      # kernel launches seen on the host
    kernels: int                       # kernels seen on the device

    def kernel_time(self, names) -> float:
        """Device time of every operation whose name contains one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:TOP]]}


def _raw(prof):
    """``(name, is_device, card, start_ns, end_ns)`` of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, e.device_index(),
                    start, start + e.duration_ns()))
    return out


class _Spans:
    """Named ``[start, end)`` intervals, for the one that overlaps a gap
    most."""

    def __init__(self, spans):
        import numpy as np

        self.names = [n for n, _, _ in spans]
        self.start = np.array([a for _, a, _ in spans], dtype=np.int64)
        self.end = np.array([b for _, _, b in spans], dtype=np.int64)

    def most(self, s: int, e: int):
        """The name overlapping ``[s, e)`` most, and how many overlap."""
        import numpy as np

        ov = np.minimum(self.end, e) - np.maximum(self.start, s)
        n = int((ov > 0).sum())
        return (self.names[int(ov.argmax())] if n else None), n


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _name_gap(s: int, e: int, host: _Spans, queries: _Spans) -> str:
    """The query in flight and the host call that overlap ``[s, e)`` most,
    and how many queries were in flight."""
    query, n = queries.most(s, e)
    call, _ = host.most(s, e)
    where = f"{query}, {n} in flight" if query else "no query in flight"
    return f"{where}: {call or 'no host call'}"


def reduce(prof, cards: List[int], queries=(), opened: float = 0.0) -> Trace:
    """Reduce a finished profiler session over ``cards`` (device indices).

    The window is the span :data:`WINDOW_SPAN`, which the caller opens when
    its streams start and closes once every query and every card is done.
    ``queries`` holds ``(name, start, end)`` on the ``time.perf_counter``
    clock, and ``opened`` is that clock's reading as the span opened."""
    events = _raw(prof)
    window = [ev for ev in events if ev[0] == WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    lo, hi = window[0][3], window[0][4]
    shift = lo - int(opened * 1e9)
    spans = _Spans([(name, int(t0 * 1e9) + shift, int(t1 * 1e9) + shift)
                    for name, t0, t1 in queries])
    kernel_ns: Dict[str, int] = {}
    per_card: Dict[int, list] = {c: [] for c in cards}
    host = []
    launches = kernels = 0
    for name, on_dev, card, s, e in events:
        if on_dev:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            kernel_ns[name] = kernel_ns.get(name, 0) + (e - s)
            if card in per_card:
                per_card[card].append((s, e))
            if not name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif name != WINDOW_SPAN:
            if name in LAUNCH_CALLS:
                launches += 1
            host.append((name, s, e))
    busy = 0
    gaps = []
    for card, iv in per_card.items():
        merged = _union(iv)
        busy += sum(e - s for s, e in merged)
        edges = [lo] + [x for se in merged for x in se] + [hi]
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e > s:
                gaps.append((e - s, s, e, card))
    gaps.sort(reverse=True)
    host = _Spans(host)
    named = []
    for length, s, e, card in gaps[:TOP]:
        label = _name_gap(s, e, host, spans)
        if len(cards) > 1:
            label = f"cuda:{card} {label}"
        named.append((label, length / 1e9))
    return Trace(window_s=(hi - lo) / 1e9, cards=len(cards),
                 busy_s=busy / 1e9 / max(1, len(cards)),
                 kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
                 idle_gaps=named, launches=launches, kernels=kernels)
