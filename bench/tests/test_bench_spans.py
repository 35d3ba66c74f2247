"""The readers of the engine's own spans (``harness.spans``): hand-worked
values on a made-up trace, nothing from a trace without the spans or
arguments they read (as a program without them gives), and, on a tiny
traced run, the padding share against the harness's own records."""
from types import SimpleNamespace

import pytest

from benchtiny import tiny_cell
from harness import runner
from harness.serve import Step
from harness.spec import reader

SEED = 2**31 + 977


def _step(t0, t1, window=True, profiled=False):
    return Step(t0, t1, [], [], 0, 0, window, profiled)


def _span(events, name, tid, t0, t1, args=None, end=None):
    events.append({"name": name, "ph": "B", "ts": t0 * 1e6, "pid": 0,
                   "tid": tid, **({"args": args} if args else {})})
    events.append({"ph": "E", "ts": t1 * 1e6, "pid": 0, "tid": tid,
                   **({"args": end} if end else {})})


def _trace(device=True, rows=True, loops=True):
    """Four steps: one before the window, two timed ones around a
    profiled one. Request 1 is admitted before the window and resumed in
    the first timed step; the last step prefills a chunk."""
    ev = []

    def pre(rid, t0, t1, bucket, n, ms, tid=1):
        end = {"tokens": n}
        if rows:
            end["rows"] = bucket
        if device:
            end["device_ms"] = ms
        _span(ev, "prefill", tid, t0, t1, {"rid": rid, "tokens": n}, end)

    def loop(t0, t1, ms):
        if loops:
            end = {"iters": 4, "active": 2}
            if device:
                end["device_ms"] = ms
            _span(ev, "decode_loop", 0, t0, t1, None, end)

    ev.append({"name": "engine_step", "ph": "B", "ts": 0.0, "pid": 0,
               "tid": 0})
    pre(1, 0.1, 0.5, 8, 5, 380.0)
    loop(0.6, 0.9, 280.0)
    ev.append({"ph": "E", "ts": 0.95e6, "pid": 0, "tid": 0})
    ev.append({"name": "engine_step", "ph": "B", "ts": 1.0e6, "pid": 0,
               "tid": 0})
    _span(ev, "plan", 0, 1.0, 1.05)
    pre(2, 1.1, 1.4, 8, 3, 250.0, tid=2)
    pre(1, 1.4, 1.5, 8, 6, 90.0)
    loop(1.55, 1.85, 200.0)
    _span(ev, "drain", 0, 1.85, 1.88)
    ev.append({"ph": "E", "ts": 1.9e6, "pid": 0, "tid": 0})
    ev.append({"name": "engine_step", "ph": "B", "ts": 2.0e6, "pid": 0,
               "tid": 0})
    pre(3, 2.1, 2.4, 8, 2, 300.0, tid=3)
    loop(2.5, 2.8, 100.0)
    ev.append({"ph": "E", "ts": 2.9e6, "pid": 0, "tid": 0})
    ev.append({"name": "engine_step", "ph": "B", "ts": 3.0e6, "pid": 0,
               "tid": 0})
    _span(ev, "prefill_chunk", 4, 3.05, 3.15, {"rid": 4},
          {"device_ms": 50.0} if device else None)
    loop(3.2, 3.4, 120.0)
    ev.append({"ph": "E", "ts": 3.6e6, "pid": 0, "tid": 0})
    steps = [_step(0.0, 0.99, window=False), _step(1.0, 1.95),
             _step(2.0, 2.95, profiled=True), _step(3.0, 3.7)]
    return SimpleNamespace(spans=ev, steps=steps)


@pytest.mark.parametrize("name,want", [
    # the fresh admission of request 2; request 1's span resumes it and
    # request 3's lies in the profiled step
    ("prefill_ms.batch", 250.0),
    # (200 + 120) device ms over 4 + 4 iterations of the timed steps
    ("decode_iter_ms.batch", 40.0),
    # (0.9 - 0.3 - 0.1 - 0.3) and (0.6 - 0.1 - 0.2) s, their mean in ms
    ("step_host_ms.batch", 250.0),
    # every window step's prefills: 1 - (3 + 6 + 2) / (8 + 8 + 8)
    ("prefill_pad_share.batch", 100.0 * (1 - 11 / 24)),
])
def test_reader_by_hand(name, want):
    assert reader(name)(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["prefill_ms.batch", "decode_iter_ms.batch",
                                  "step_host_ms.batch",
                                  "prefill_pad_share.batch"])
def test_reader_without_its_spans_gives_none(name):
    read = reader(name)
    assert read(SimpleNamespace(spans=None, steps=_trace().steps)) is None
    assert read(SimpleNamespace(spans=[], steps=_trace().steps)) is None
    # a program that records prefill spans only, with neither rows nor
    # device times, and no decode loop
    assert read(_trace(device=False, rows=False, loops=False)) is None


def test_tiny_traced_run_pads_as_the_harness_reckons(monkeypatch):
    """On the CPU the spans carry no device time; the padding share
    equals the one the harness's own (prompt, bucket) records give, and
    the step's self time is part of the step."""
    views = []

    class Keep(runner.RunView):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            views.append(self)

    monkeypatch.setattr(runner, "RunView", Keep)
    out = runner.run(tiny_cell("backlog"), SEED, 1.5, True, "cpu", 0.0,
                     log=lambda s: None)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "prefill_ms.batch" not in m and "decode_iter_ms.batch" not in m
    adm = [a for s in views[0].steps if s.window for a in s.admitted]
    assert adm
    want = 100.0 * (1 - sum(p for p, _ in adm) / sum(b for _, b in adm))
    assert m["prefill_pad_share.batch"] == pytest.approx(want)
    assert 0 < m["step_host_ms.batch"] < m["engine_step_ms.batch"]
