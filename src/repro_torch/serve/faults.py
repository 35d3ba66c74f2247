"""Fault injection for the GLB fabric — one chaos harness, two workload
shapes (DESIGN.md §15): the serving fabric (``GLBReplicaBalancer``) and the
task executor (``core.scheduler.run_sim``). A copy of
``repro.serve.faults``.

The injector models the three failure shapes a distributed GLB deployment
actually sees, keyed to the superstep clock both schedulers already run on:

* **crash** — the place stops answering the load-vector gather and never
  comes back. Its queued/running work is lost and must be re-admitted by
  the survivors (the balancer's ledger recovery / the simulator's bag
  drain).
* **hang** — the place stops answering for ``duration`` supersteps, then
  resumes. A hang shorter than the detection window (``heartbeat_misses``
  consecutive missed gathers) is absorbed with no recovery; a longer one
  is indistinguishable from a crash at detection time, so the place is
  declared dead and **fenced**: even after it "wakes up" it is never
  stepped again (a zombie double-producing tokens would corrupt the
  fabric).
* **slow** — the place answers every gather (responsive) but only makes
  compute progress every ``factor``-th superstep. A slow place must NOT
  be declared dead — this is the shape that tests the detection window's
  specificity, not its sensitivity.

The same injector drives both the serving fabric (``GLBReplicaBalancer``
consults ``responsive``/``should_step`` per replica per balance pass) and
the taskbag simulator (``core.scheduler.run_sim(faults=...)`` consults it
per place per superstep). "Replica" and "place" are the same index space
to the injector.

Determinism: the injector holds no RNG — faults fire at the exact
superstep they were scheduled for, so chaos tests are seeded and
reproducible, and the crash-at-every-superstep sweep is a plain loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``kind`` in {"crash", "hang", "slow"}.

    at        — superstep index the fault fires (inclusive).
    duration  — hang only: supersteps until the place resumes
                (None = never, equivalent to crash).
    factor    — slow only: the place steps once every `factor`
                supersteps from `at` on.
    """

    kind: str
    place: int
    at: int
    duration: Optional[int] = None
    factor: int = 2

    def __post_init__(self):
        if self.kind not in ("crash", "hang", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "slow" and self.factor < 2:
            raise ValueError("slow fault needs factor >= 2")

    def _active(self, step: int) -> bool:
        if step < self.at:
            return False
        if self.kind == "hang" and self.duration is not None:
            return step < self.at + self.duration
        return True


class FaultInjector:
    """Schedule of faults consulted by the superstep loop.

    Protocol (both schedulers follow it):
      1. ``begin_superstep(step)`` once per superstep, before the gather;
      2. ``responsive(p)`` — does place p answer this gather? (heartbeat)
      3. ``should_step(p)`` — does place p make compute progress this
         superstep? (a crashed/hung place doesn't; a slow one sometimes)
    """

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults: List[Fault] = list(faults or [])
        self._step = 0
        self.fired: List[Fault] = []   # faults that have activated at
                                       # least once (for reports/tests)

    # ------------------------------------------------------------ schedule
    def crash(self, place: int, at: int) -> "FaultInjector":
        self.faults.append(Fault("crash", place, at))
        return self

    def hang(self, place: int, at: int,
             duration: Optional[int] = None) -> "FaultInjector":
        self.faults.append(Fault("hang", place, at, duration=duration))
        return self

    def slow(self, place: int, at: int, factor: int = 2) -> "FaultInjector":
        self.faults.append(Fault("slow", place, at, factor=factor))
        return self

    # ------------------------------------------------------------- queries
    def begin_superstep(self, step: int) -> None:
        self._step = step
        for f in self.faults:
            if f._active(step) and f not in self.fired:
                self.fired.append(f)

    def responsive(self, place: int) -> bool:
        """Heartbeat: does `place` answer this superstep's load gather?
        Slow places always do — slowness is a compute property, not a
        liveness one."""
        for f in self.faults:
            if f.place == place and f.kind in ("crash", "hang") \
                    and f._active(self._step):
                return False
        return True

    def should_step(self, place: int) -> bool:
        """Does `place` make compute progress this superstep?"""
        for f in self.faults:
            if f.place != place or not f._active(self._step):
                continue
            if f.kind in ("crash", "hang"):
                return False
            if f.kind == "slow" and (self._step - f.at) % f.factor != 0:
                return False
        return True
