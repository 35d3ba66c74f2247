"""Fabric-wide tracing: monotonic-clock spans + instant events exported
as Chrome ``trace_event`` JSON (load the file at https://ui.perfetto.dev).

The GLB paper makes per-worker *logging* a first-class library feature
(§2.4: time processing vs distributing, steals sent/received, workload
shipped); this module is the timeline-resolved generalization for the
whole stack — one trace vocabulary shared by taskbag GLB runs and the
LM serving fabric:

* **duration spans** (``ph: B/E``) — per-replica work: engine steps,
  prefill chunks, migration pack/land, GLB supersteps. Owned by the
  ``(pid, tid)`` track that opened them; ``Tracer`` keeps a per-track
  stack so ``end()`` needs no name and export can prove balance.
* **request lifecycle spans** (async ``ph: b/n/e``, keyed by request
  id) — ``queued -> prefill -> decode -> finished`` with ``preempted`` /
  ``resumed`` / ``migrated_out`` / ``migrated_in`` instants in between.
  Async events are keyed by ``id`` (not pid), so ONE shared Tracer
  stitches a request's life across every replica it visits: the replica
  that opens a phase is recorded in that event's ``pid``, and the next
  owner's ``req_phase`` closes it — span ownership transfers with the
  request (DESIGN.md §10).
* **counter tracks** (``ph: C``) — pool occupancy, queue depth, token
  budget split, fabric load vector: the measurement substrate for
  cost-modeled balancing.

Overhead contract: the default is the module-level :data:`NULL_TRACER`
whose ``enabled`` is False — every instrumentation site guards with
``if tracer.enabled:``, so the disabled hot path pays ONE attribute
check and no call, no allocation, no clock read. What tracing costs
when it is on is measured on the card: the benchmark's
``engine_step_ms.batch`` (``python3 bench/run.py ... --trace 1``, whose
engine carries a ``Tracer``) against the same run of a tree without the
spans, and one engine's steps timed with the tracer on and off in turn
(PERF.md keeps both readings).

Clock domain: timestamps are ``time.perf_counter_ns() / 1e3`` µs, the
clock of ``time.perf_counter``, which the benchmark's harness also
reads, so its step records and these events share one axis.
:func:`clock_sync` returns a ``(unix_ts, perf_us)`` pair, which the
tracer stamps into the export's ``otherData`` to place the trace on the
wall clock. A span may also carry ``device_ms`` in its end event's
``args``: the device's own time between two CUDA events recorded at its
edges (the serving engine's prefill and decode-loop spans).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


def now_us() -> float:
    """Monotonic microseconds — the Chrome trace_event clock."""
    return time.perf_counter_ns() / 1e3


def atomic_write_json(path: str, obj: Any) -> None:
    """Write ``obj`` as JSON via a temp file in the same directory plus
    ``os.replace`` — an interrupted run leaves either the previous
    complete file or the new complete file, never a truncated one
    (``BENCH_serve_trace.json`` is parsed by the CI analyze gate, so a
    half-written artifact would fail the wrong step). Used by
    ``Tracer.write`` and ``FlightRecorder.dump``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".trace.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def clock_sync() -> Dict[str, float]:
    """One point relating the wall clock to the trace clock, stamped
    into both trace exports: ``unix = unix_ts + (ts - perf_us) / 1e6``."""
    return {"unix_ts": time.time(), "perf_us": now_us()}


class NullTracer:
    """The disabled tracer: every emit is a no-op and ``enabled`` is
    False, so guarded call sites (``if tracer.enabled:``) never even
    enter the method. Shared singleton: :data:`NULL_TRACER`."""

    enabled = False
    events: tuple = ()

    def begin(self, *a, **k):                   # pragma: no cover - no-op
        pass

    def end(self, *a, **k):                     # pragma: no cover - no-op
        pass

    @contextmanager
    def span(self, *a, **k):
        yield

    def instant(self, *a, **k):                 # pragma: no cover - no-op
        pass

    def counter(self, *a, **k):                 # pragma: no cover - no-op
        pass

    def req_begin(self, *a, **k):               # pragma: no cover - no-op
        pass

    def req_phase(self, *a, **k):               # pragma: no cover - no-op
        pass

    def req_instant(self, *a, **k):             # pragma: no cover - no-op
        pass

    def req_end(self, *a, **k):                 # pragma: no cover - no-op
        pass

    def process_name(self, *a, **k):            # pragma: no cover - no-op
        pass

    def thread_name(self, *a, **k):             # pragma: no cover - no-op
        pass

    def flush(self):                            # pragma: no cover - no-op
        pass

    def dump(self):                             # pragma: no cover - no-op
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {}}

    def write(self, path):                      # pragma: no cover - no-op
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace_event dicts in memory; ``write()`` emits a
    Perfetto-loadable JSON object. One Tracer is shared by every replica
    of a fabric (async request spans cross replicas); ``pid`` is the
    replica / place id, ``tid`` subdivides a replica's tracks."""

    enabled = True

    def __init__(self, cat: str = "serve"):
        self.events: List[dict] = []
        self.default_cat = cat
        self.sync = clock_sync()        # unix <-> perf_counter anchor
        self._stacks: Dict[tuple, List[str]] = {}   # (pid,tid) -> names
        self._req_phase: Dict[Any, tuple] = {}      # rid -> (phase, pid)
        self._named_pids: set = set()
        self._named_tids: set = set()

    # ------------------------------------------------------- duration spans
    def begin(self, name: str, pid: int = 0, tid: int = 0,
              cat: Optional[str] = None, args: Optional[dict] = None,
              ts: Optional[float] = None) -> None:
        ev = {"name": name, "cat": cat or self.default_cat, "ph": "B",
              "ts": now_us() if ts is None else ts, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)
        self._stacks.setdefault((pid, tid), []).append(name)

    def end(self, pid: int = 0, tid: int = 0,
            args: Optional[dict] = None,
            ts: Optional[float] = None) -> Optional[dict]:
        """Close the innermost open span of the track. Returns the end
        event appended (None for an unmatched end), so that a caller can
        add an argument it learns later, such as a device time."""
        stack = self._stacks.get((pid, tid))
        if not stack:       # unmatched end: drop rather than corrupt
            return None
        stack.pop()
        ev = {"ph": "E", "ts": now_us() if ts is None else ts,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    @contextmanager
    def span(self, name: str, pid: int = 0, tid: int = 0,
             cat: Optional[str] = None, args: Optional[dict] = None):
        self.begin(name, pid=pid, tid=tid, cat=cat, args=args)
        try:
            yield
        finally:
            self.end(pid=pid, tid=tid)

    # ------------------------------------------------------ instants/counters
    def instant(self, name: str, pid: int = 0, tid: int = 0,
                cat: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat or self.default_cat, "ph": "i",
              "ts": now_us(), "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, values: Dict[str, float], pid: int = 0,
                tid: int = 0) -> None:
        self.events.append({
            "name": name, "cat": self.default_cat, "ph": "C",
            "ts": now_us(), "pid": pid, "tid": tid,
            "args": {k: float(v) for k, v in values.items()},
        })

    # --------------------------------------------- request lifecycle (async)
    # Async events share one timeline per (cat, id) regardless of which
    # pid emitted them — the mechanism that lets a request's spans stay
    # correctly parented when it migrates between replicas. The tracer
    # tracks the open phase per rid so phase transitions always close
    # the previous phase first (spans stay balanced by construction).
    def _aev(self, ph: str, name: str, rid, pid: int,
             args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": "request", "ph": ph, "ts": now_us(),
              "pid": pid, "tid": 0, "id": f"req{rid}"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def req_begin(self, rid, pid: int = 0,
                  args: Optional[dict] = None) -> None:
        if rid in self._req_phase:
            return                       # already alive (e.g. resubmit)
        self._aev("b", "request", rid, pid, args)
        self._req_phase[rid] = (None, pid)

    def req_phase(self, rid, phase: str, pid: int = 0,
                  args: Optional[dict] = None) -> None:
        """Transition ``rid`` to ``phase``: closes the open phase (opened
        by whichever replica owned the request last) and opens the new
        one under ``pid``. Unknown rids are auto-begun, so a thief-side
        tracer that never saw submit() still emits balanced spans."""
        if rid not in self._req_phase:
            self.req_begin(rid, pid=pid)
        prev, prev_pid = self._req_phase[rid]
        if prev is not None:
            self._aev("e", prev, rid, prev_pid)
        self._aev("b", phase, rid, pid, args)
        self._req_phase[rid] = (phase, pid)

    def req_instant(self, rid, name: str, pid: int = 0,
                    args: Optional[dict] = None) -> None:
        if rid not in self._req_phase:
            self.req_begin(rid, pid=pid)
        self._aev("n", name, rid, pid, args)

    def req_end(self, rid, pid: int = 0,
                args: Optional[dict] = None) -> None:
        state = self._req_phase.pop(rid, None)
        if state is None:
            return
        phase, phase_pid = state
        if phase is not None:
            self._aev("e", phase, rid, phase_pid)
        self._aev("e", "request", rid, pid, args)

    # ------------------------------------------------------------- metadata
    def process_name(self, pid: int, name: str) -> None:
        if pid in self._named_pids:
            return
        self._named_pids.add(pid)
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "ts": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._named_tids:
            return
        self._named_tids.add((pid, tid))
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "ts": 0, "args": {"name": name}})

    # -------------------------------------------------------------- export
    def flush(self) -> None:
        """Close every still-open duration span and request phase so the
        exported JSON is balanced even for an interrupted run."""
        for (pid, tid), stack in self._stacks.items():
            while stack:
                stack.pop()
                self.events.append({"ph": "E", "ts": now_us(),
                                    "pid": pid, "tid": tid})
        for rid in list(self._req_phase):
            self.req_end(rid, pid=self._req_phase[rid][1],
                         args={"flushed": True})

    def to_chrome(self) -> dict:
        """The Chrome trace_event JSON object format (call ``flush()``
        first — ``write()`` does — if balance matters)."""
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"clock_sync": self.sync},
        }

    def dump(self) -> dict:
        """Balanced trace dict WITHOUT mutating tracer state: still-open
        duration spans and request phases are closed in the exported
        copy only, so a live tracer can be analyzed mid-run
        (``obs.analyze.analyze_trace`` calls this) and keep tracing."""
        events = list(self.events)
        ts = now_us()
        for (pid, tid), stack in self._stacks.items():
            for _ in stack:
                events.append({"ph": "E", "ts": ts, "pid": pid,
                               "tid": tid})
        for rid, (phase, pid) in self._req_phase.items():
            if phase is not None:
                events.append({"name": phase, "cat": "request",
                               "ph": "e", "ts": ts, "pid": pid,
                               "tid": 0, "id": f"req{rid}"})
            events.append({"name": "request", "cat": "request",
                           "ph": "e", "ts": ts, "pid": pid, "tid": 0,
                           "id": f"req{rid}",
                           "args": {"flushed": True}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"clock_sync": self.sync},
        }

    def write(self, path: str) -> None:
        self.flush()
        atomic_write_json(path, self.to_chrome())


def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema check used by tests and the bench artifact step: every
    event carries pid/tid/ts/ph, duration spans are balanced LIFO per
    (pid, tid), and async b/e are balanced per (cat, id). Returns a list
    of problems (empty = valid)."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[tuple, int] = {}
    adepth: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        for field in ("ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
        ph = ev.get("ph")
        if ph in ("B", "M", "i", "C", "b", "n") and "name" not in ev:
            problems.append(f"event {i} (ph={ph}) missing name")
        if ph == "B":
            key = (ev.get("pid"), ev.get("tid"))
            stacks[key] = stacks.get(key, 0) + 1
        elif ph == "E":
            key = (ev.get("pid"), ev.get("tid"))
            depth = stacks.get(key, 0)
            if depth <= 0:
                problems.append(f"event {i}: E without open B on {key}")
            else:
                stacks[key] = depth - 1
        elif ph in ("b", "n", "e"):
            if "id" not in ev:
                problems.append(f"event {i} (ph={ph}) missing id")
            key = (ev.get("cat"), ev.get("id"))
            if ph == "b":
                adepth[key] = adepth.get(key, 0) + 1
            elif ph == "e":
                depth = adepth.get(key, 0)
                if depth <= 0:
                    problems.append(f"event {i}: async e without b {key}")
                else:
                    adepth[key] = depth - 1
            elif adepth.get(key, 0) <= 0:
                problems.append(f"event {i}: async n outside b..e {key}")
    for key, depth in stacks.items():
        if depth:
            problems.append(f"{depth} unclosed duration span(s) on {key}")
    for key, depth in adepth.items():
        if depth:
            problems.append(f"{depth} unclosed async span(s) on {key}")
    return problems
