"""The closed loop: ``streams`` query streams, one thread each, each
submitting its next query the moment the last one returns.

A traffic mix with ``"loop": "closed"`` gives ``streams`` and ``mix`` (the
names of its queries).  Each stream runs its order of the mix, cycled,
until the window closes; a query's latency runs from the call to its
answer on the host.  TPC-H's throughput test and the paper's fig11 are
loops of this kind.
"""
from __future__ import annotations

import math
import random
import threading
import time
from typing import Dict, List, Optional

from portbench.harness import GRACE_S, Query, ops_of

#: share of the window's row answers kept for the comparison, drawn from
#: the seed; each stream's first row answer is always kept
KEEP_ROWS = 0.25
#: rounds of every stream's order of the mix run concurrently in the
#: warm-up
WARM_ROUNDS = 2


def stream_plan(seed: int, streams: int, mix: List[str]):
    """Per stream, its order of the mix and a generator of its keep
    decisions, from the seed alone.

    The seed draws one permutation of the mix; stream ``i`` runs its
    rotation by ``i``, and the seed deals the rotations out to the streams.
    So every seed starts as many streams on each query, and only which
    streams, the order and the data change with the seed: streams that
    start together are admitted to the card together and tend to stay in
    step, so an unequal deal would change the work that overlaps on the
    card from seed to seed."""
    rng = random.Random(f"portbench/{seed}")
    base = rng.sample(list(mix), len(mix))
    rotations = [base[i % len(base):] + base[:i % len(base)]
                 for i in range(streams)]
    rng.shuffle(rotations)
    return [(rot, random.Random(f"portbench/{seed}/{i}"))
            for i, rot in enumerate(rotations)]


class Streams:
    """Closed-loop query streams, one thread each: each runs its order of
    the mix, cycled, until the time :meth:`release` sets or, with
    ``rounds``, that many times through it."""

    def __init__(self, server, built: Dict[str, object], plans,
                 rounds: Optional[int] = None):
        self.server, self.built, self.plans = server, built, plans
        self.records: List[List[Query]] = [[] for _ in plans]
        self.end = math.inf
        self.rounds = rounds
        self._go = threading.Event()
        self._threads = [threading.Thread(target=self._stream, args=(i,),
                                          name=f"portbench-stream-{i}",
                                          daemon=True)
                         for i in range(len(plans))]

    def _stream(self, i: int) -> None:
        perm, rng = self.plans[i]
        seen_rows = False
        self._go.wait()
        seq = 0
        while self.rounds is None or seq < self.rounds * len(perm):
            name = perm[seq % len(perm)]
            t0 = time.perf_counter()
            if t0 >= self.end:
                break
            rec = Query(i, seq, name, t0, t0)
            try:
                res = self.server.submit(self.built[name])
            except Exception as exc:  # the query failed; the run goes on
                rec.t1 = time.perf_counter()
                rec.error = f"{type(exc).__name__}: {exc}"
            else:
                rec.t1 = time.perf_counter()
                rec.ops = ops_of(res)
                if res.relation is None:
                    rec.scalar = res.scalar
                else:
                    keep = rng.random() < KEEP_ROWS or not seen_rows
                    seen_rows = True
                    rec.rows = res.relation if keep else None
            self.records[i].append(rec)
            seq += 1

    def start(self) -> None:
        """Start the threads; they wait for :meth:`release`."""
        for t in self._threads:
            t.start()

    def release(self, seconds: Optional[float] = None) -> float:
        """Let every stream go; with ``seconds``, until that many seconds
        from now.  Returns the release time."""
        now = time.perf_counter()
        if seconds is not None:
            self.end = now + seconds
        self._go.set()
        return now

    def join(self, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"streams {alive} did not return within "
                               f"{timeout:.0f} s")

    def queries(self) -> List[Query]:
        return [q for recs in self.records for q in recs]


def warm(server, built: Dict[str, object], traffic: dict, seed: int) -> None:
    """Each query of the mix once, then :data:`WARM_ROUNDS` rounds of every
    stream's order concurrently, as the window will run them."""
    for name in traffic["mix"]:
        server.submit(built[name])
    streams = Streams(server, built,
                      stream_plan(seed, traffic["streams"], traffic["mix"]),
                      rounds=WARM_ROUNDS)
    streams.start()
    streams.release()
    streams.join(GRACE_S * 5)
    errors = [q.error for q in streams.queries() if q.error]
    if errors:
        raise RuntimeError(f"warm-up: {len(errors)} queries failed, first: "
                           f"{errors[0]}")


def window(server, built: Dict[str, object], traffic: dict,
           seed: int) -> Streams:
    """The measured window's streams, started and waiting for
    ``release(seconds)``."""
    streams = Streams(server, built,
                      stream_plan(seed, traffic["streams"], traffic["mix"]))
    streams.start()
    return streams
