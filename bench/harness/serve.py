"""Drives the serving engine through ``submit()`` and ``step()`` under a
traffic mix, and records what a client sees, on the host clock.

Every time here is ``time.perf_counter()`` seconds. A token is seen when
the ``step()`` that produced it returns (each step ends in the engine's
own drain of its token buffer to the host), so a request's first-token
and last-token times are step ends.

``backlog``: a closed loop. At least ``max_slots`` requests wait in the
queue before every step. Set-up fills every slot and runs ``warm_steps``
more; the window is then whole steps, from the first one's start until
``seconds`` have passed, and its rates are over all the work and all the
time of those steps.

``poisson``: an open loop. Requests are submitted once due, whatever the
engine is doing. One request served first, outside the records, builds or
loads the kernels; arrivals then start ``warmup_s`` before the window opens;
the window is the ``seconds`` in which requests fall due. After it
closes, arrivals go on until every request due in the window has its
first token (a minute at most): that moment is ``stop``, the end of what
the latencies read. Then arrivals stop and the engine drains the
window's requests (a minute at most). A request due in the window that
has no first token at ``stop``, or no end after the drain, has failed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from .system import Request

TAIL_CAP_S = 60.0
WARM_RID = -(1 << 40)         # no request of the traffic has this id


@dataclasses.dataclass
class Rec:
    i: int
    req: Request
    prompt_len: int
    due: float                    # due (open loop) or submit time
    window: bool = False          # due in the window (open loop)
    t_first: Optional[float] = None
    t_tok: Optional[float] = None     # the last step that gave it tokens
    t_done: Optional[float] = None
    t_last: Optional[float] = None    # t_tok at ``stop``
    n_last: int = 0                   # tokens seen by ``stop``


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    admitted: List[int]            # prompt lengths admitted here
    decode: List[tuple]            # (cache length before, tokens) a slot
    prompt_tokens: int
    out_tokens: int
    window: bool
    profiled: bool


class LoadLoop:
    """One run of one engine under one mix. ``on_boundary(now)`` is
    called between steps (the profiler's slice starts and stops there)
    and returns whether the coming step is inside a profiled slice."""

    def __init__(self, engine, traffic, engine_cfg: dict, seconds: float,
                 clock: Callable[[], float] = time.perf_counter,
                 on_boundary=None):
        self.eng, self.traffic, self.ecfg = engine, traffic, engine_cfg
        self.seconds = seconds
        self.clock = clock
        self.on_boundary = on_boundary or (lambda now: False)
        self.recs: List[Rec] = []
        self.live: List[Rec] = []
        self.steps: List[Step] = []
        self.window = (0.0, 0.0)
        self.t_open = float("inf")    # when the window opens
        self.stop = None

    # ------------------------------------------------------------ requests
    def submit(self, due: float, window: bool = False) -> Rec:
        i = len(self.recs)
        prompt, max_new = self.traffic.request(i)
        req = Request(rid=i, prompt=prompt, max_new=max_new)
        rec = Rec(i, req, len(prompt), due, window)
        self.recs.append(rec)
        self.live.append(rec)
        self.eng.submit(req)
        return rec

    def step(self, window: bool) -> Step:
        before = [(r, len(r.req.out)) for r in self.live]
        profiled = self.on_boundary(self.clock())
        t0 = self.clock()
        self.eng.step()
        t1 = self.clock()
        st = Step(t0, t1, [], [], 0, 0, window, profiled)
        for r, n0 in before:
            n1 = len(r.req.out)
            if n1 == n0:
                continue
            r.t_tok = t1
            st.out_tokens += n1 - n0
            if n0 == 0:
                r.t_first = t1
                st.admitted.append(r.prompt_len)
                st.prompt_tokens += r.prompt_len
                if n1 > 1:
                    st.decode.append((r.prompt_len, n1 - 1))
            else:
                st.decode.append((r.prompt_len + n0 - 1, n1 - n0))
            if r.req.done:
                r.t_done = t1
        self.live = [r for r in self.live if not r.req.done]
        self.steps.append(st)
        return st

    # ------------------------------------------------------------- backlog
    def _top_up(self) -> None:
        while len(self.eng.queue) < self.ecfg["max_slots"]:
            self.submit(self.clock())

    def run_backlog(self, warm_steps: int) -> None:
        """Set-up (fill, then ``warm_steps``), then the window."""
        for k in range(1 + warm_steps):
            self._top_up()
            self.step(False)
        self.t_open = self.clock()
        while True:
            self._top_up()
            st = self.step(True)
            if st.t1 - self.t_open >= self.seconds:
                break
        self.on_boundary(float("inf"))
        self.window = (next(s.t0 for s in self.steps if s.window),
                       self.steps[-1].t1)

    # ------------------------------------------------------------- poisson
    def warm(self) -> None:
        """Serve one request outside the records, so that the kernels are
        built or loaded and the cell's shapes run once before any arrival
        (a prompt of ``pad_len`` tokens, the longest the engine admits)."""
        req = Request(rid=WARM_RID, prompt=[1] * self.ecfg["pad_len"],
                      max_new=1)
        self.eng.submit(req)
        while not req.done:
            self.eng.step()

    def run_poisson(self, warmup_s: float, tail: bool = True) -> None:
        """Arrivals from now; the window opens after ``warmup_s``. Without
        ``tail`` the run ends when the window closes (the knee sweep)."""
        self.warm()
        start = self.clock()
        self.t_open = w0 = start + warmup_s
        w1 = w0 + self.seconds
        self.window = (w0, w1)
        arrivals = True
        while True:
            now = self.clock()
            while arrivals:
                due = start + self.traffic.due(len(self.recs))
                if due > now:
                    break
                self.submit(due, window=w0 <= due < w1)
            if not tail and now >= w1:
                break
            if arrivals and now >= w1:
                waiting = any(r.window and r.t_first is None
                              for r in self.recs)
                if not waiting or now >= w1 + TAIL_CAP_S:
                    arrivals = False
                    self.stop = now
                    for r in self.recs:
                        r.t_last, r.n_last = r.t_tok, len(r.req.out)
            if not arrivals:
                left = any(r.window and not r.req.done for r in self.recs)
                if not left or now >= self.stop + TAIL_CAP_S:
                    break
            if self.eng.load > 0:
                self.step(w0 <= now < w1)
            elif arrivals:
                nxt = start + self.traffic.due(len(self.recs))
                time.sleep(max(0.0, min(nxt, max(w1, now + 1e-3)) - now))
            else:
                time.sleep(0.01)
        self.on_boundary(float("inf"))
