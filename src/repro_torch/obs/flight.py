"""Flight recorder: a bounded ring-buffer tracer that makes always-on
tracing a fixed-memory default instead of an unbounded opt-in. A copy of
``repro.obs.flight``.

``FlightRecorder`` IS a :class:`~repro_torch.obs.trace.Tracer` — every emit
site (engine, scheduler, radix cache, balancer, SLO monitor) works
unchanged — but events land in a drop-oldest ring of ``capacity``
entries, so a fabric can run traced forever and still hold the last N
events when something goes wrong (the black-box-recorder pattern).

The hard part is the export contract: the oldest half of a span pair
falls off the ring first (its ``B``/``b`` is older than its ``E``/``e``
by construction), so a naive JSON dump of the ring is unbalanced and
Perfetto/``validate_chrome_trace`` reject it. :meth:`FlightRecorder.dump`
therefore synthesizes an open at the ring's start timestamp for every
close whose open was evicted — ``(truncated)`` duration spans per
``(pid, tid)`` track and ``(truncated)`` async opens per ``(cat, id)``
— and re-emits process/thread metadata (kept OUT of the ring so names
never age out). The result passes ``validate_chrome_trace`` at EVERY
capacity (tested from 1 upward), and ``otherData.flight`` records
``capacity`` / ``dropped`` / ``synthesized_opens`` so a reader knows
how much history was lost.

``dump()`` is non-destructive (the recorder keeps recording after an
export) and ``write()`` routes through the same atomic temp-file +
``os.replace`` path as ``Tracer.write``.

Overhead: an append to a maxlen deque is O(1) like the list append the
unbounded tracer does, and recording adds no host sync.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Tuple

from .trace import Tracer, atomic_write_json, now_us


class _Ring(deque):
    """Drop-oldest deque that counts how many events it evicted."""

    def __init__(self, maxlen: int):
        super().__init__(maxlen=maxlen)
        self.dropped = 0

    def append(self, ev) -> None:
        if len(self) == self.maxlen:
            self.dropped += 1
        super().append(ev)


class FlightRecorder(Tracer):
    """Bounded-memory tracer with the full ``Tracer`` API. ``capacity``
    is the maximum number of retained events; everything older is
    dropped (oldest first) and only counted."""

    def __init__(self, capacity: int = 4096, cat: str = "serve"):
        if capacity < 1:
            raise ValueError(f"flight ring capacity must be >= 1, "
                             f"got {capacity}")
        super().__init__(cat=cat)
        self.capacity = capacity
        self.events = _Ring(maxlen=capacity)
        # Names live OUTSIDE the ring: a metadata event that aged out
        # would leave pids anonymous in the dump, and metadata occupying
        # ring slots would shrink the useful history.
        self._pid_names: Dict[int, str] = {}
        self._tid_names: Dict[Tuple[int, int], str] = {}

    @property
    def dropped(self) -> int:
        return self.events.dropped

    # ------------------------------------------------------------- metadata
    def process_name(self, pid: int, name: str) -> None:
        self._pid_names[pid] = name

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._tid_names[(pid, tid)] = name

    # --------------------------------------------------------------- export
    def dump(self) -> dict:
        """Balanced, validator-clean trace of the ring contents. Three
        synthesis passes over a COPY (recording continues untouched):

        1. close still-open spans/phases (the tracer's ``_stacks`` /
           ``_req_phase`` bookkeeping survives eviction, so this is
           exact — same as ``Tracer.dump``);
        2. for every close whose open fell off the ring, prepend a
           ``(truncated)`` open at the ring-start timestamp (the
           validator and Perfetto only need depth balance, so
           synthesized opens stack at the window edge);
        3. prepend fresh process/thread metadata from the name maps.
        """
        events = list(self.events)
        ts_close = now_us()
        for (pid, tid), stack in self._stacks.items():
            for _ in stack:
                events.append({"ph": "E", "ts": ts_close, "pid": pid,
                               "tid": tid})
        for rid, (phase, pid) in self._req_phase.items():
            if phase is not None:
                events.append({"name": phase, "cat": "request",
                               "ph": "e", "ts": ts_close, "pid": pid,
                               "tid": 0, "id": f"req{rid}"})
            events.append({"name": "request", "cat": "request",
                           "ph": "e", "ts": ts_close, "pid": pid,
                           "tid": 0, "id": f"req{rid}",
                           "args": {"flushed": True}})
        t0 = min((e["ts"] for e in events if e.get("ts", 0) > 0),
                 default=0.0)
        opens = []
        depth: Dict[tuple, int] = {}
        for ev in events:
            ph = ev.get("ph")
            if ph == "B":
                key = ("d", ev.get("pid"), ev.get("tid"))
                depth[key] = depth.get(key, 0) + 1
            elif ph == "E":
                key = ("d", ev.get("pid"), ev.get("tid"))
                if depth.get(key, 0) > 0:
                    depth[key] -= 1
                else:
                    opens.append({
                        "name": "(truncated)", "cat": "flight",
                        "ph": "B", "ts": t0, "pid": ev.get("pid"),
                        "tid": ev.get("tid"),
                        "args": {"synthesized": True},
                    })
            elif ph in ("b", "n", "e"):
                key = ("a", ev.get("cat"), ev.get("id"))
                if ph == "b":
                    depth[key] = depth.get(key, 0) + 1
                    continue
                if depth.get(key, 0) > 0:
                    if ph == "e":
                        depth[key] -= 1
                    continue
                # e with no open: open+close cancel (depth stays 0);
                # n with no open: the synthesized open covers the rest
                # of the window (a later e will consume it).
                opens.append({
                    "name": "(truncated)", "cat": ev.get("cat"),
                    "ph": "b", "ts": t0, "pid": ev.get("pid"),
                    "tid": 0, "id": ev.get("id"),
                    "args": {"synthesized": True},
                })
                if ph == "n":
                    depth[key] = depth.get(key, 0) + 1
        # The ring holds a contiguous SUFFIX of the event stream, so any
        # open in the ring whose close exists is ring-resident too, and
        # genuinely-open spans were closed above from _stacks/_req_phase.
        # Leftover positive depth therefore only comes from opens we
        # synthesized for orphan "n" instants — close them at the edge.
        for key, d in depth.items():
            for _ in range(d):
                if key[0] == "d":
                    events.append({"ph": "E", "ts": ts_close,
                                   "pid": key[1], "tid": key[2]})
                else:
                    events.append({"name": "(truncated)", "cat": key[1],
                                   "ph": "e", "ts": ts_close, "pid": 0,
                                   "tid": 0, "id": key[2],
                                   "args": {"synthesized": True}})
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "ts": 0, "args": {"name": name}}
                for pid, name in sorted(self._pid_names.items())]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid,
                  "tid": tid, "ts": 0, "args": {"name": name}}
                 for (pid, tid), name in sorted(self._tid_names.items())]
        return {
            "traceEvents": meta + opens + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "clock_sync": self.sync,
                "flight": {
                    "capacity": self.capacity,
                    "dropped": self.events.dropped,
                    "synthesized_opens": len(opens),
                },
            },
        }

    def write(self, path: str) -> None:
        # No flush(): dump() balances the copy, the ring keeps recording.
        atomic_write_json(path, self.dump())
