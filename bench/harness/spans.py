"""The engine's own trace (``RunView.spans``, the events of its
``Tracer``) as duration spans, each put down to the harness's step whose
``[t0, t1]`` holds its start. Both clocks are ``time.perf_counter``: a
trace event's ``ts`` is its microseconds.

The engine's spans (``repro_torch.serve.engine``): ``engine_step`` on
the replica's track (tid 0) with the children ``plan``, ``decode_loop``
(end args ``iters``, ``active``) and ``drain``; ``prefill`` (end args
``rows``, ``tokens``) and ``prefill_chunk`` on a slot's track. On a CUDA
device the end event of ``prefill``, ``prefill_chunk`` and
``decode_loop`` carries ``device_ms``. A program without a span or an
argument gives none, and the readers then return None."""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class Span:
    name: str
    tid: int
    t0: float                 # seconds, perf_counter
    t1: float
    args: dict                # the begin event's args, then the end's

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def parse(events) -> List[Span]:
    """Duration spans from the B/E events, matched last in, first out on
    each (pid, tid) track."""
    stacks: Dict[tuple, list] = {}
    out: List[Span] = []
    for ev in events or ():
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E" and stacks.get(key):
            b = stacks[key].pop()
            out.append(Span(b.get("name", ""), key[1], b["ts"] / 1e6,
                            ev["ts"] / 1e6, {**b.get("args", {}),
                                             **ev.get("args", {})}))
    return out


def by_step(run, steps) -> Dict[int, List[Span]]:
    """The spans whose start lies in one of ``steps`` (harness ``Step``
    records), keyed by the step's index in ``steps``."""
    starts = [s.t0 for s in steps]
    out: Dict[int, List[Span]] = {}
    for sp in parse(run.spans):
        k = bisect.bisect_right(starts, sp.t0) - 1
        if k >= 0 and sp.t0 <= steps[k].t1:
            out.setdefault(k, []).append(sp)
    return out


def timed_steps(run):
    """The window's steps outside the profiled slice (the steps that
    ``engine_step_ms.batch`` reads)."""
    return [s for s in run.steps if s.window and not s.profiled]
