"""The serving engine's phase spans (``serve.engine._Phases``): inside
every ``engine_step`` on the replica's track the children ``plan``,
``decode_loop`` and ``drain``; ``prefill`` spans on the slots' tracks
with the rows launched and the prefix rows among them; the
``prefill_rows`` / ``prefill_tokens`` counters; nothing at all with the
tracer off; host-only ``engine.*`` profiler ranges; and on a CUDA device
``device_ms`` read from CUDA events only after a drain has synchronised
the stream (here with stand-in events on the host clock; on the card by
the test marked ``cuda``, which runs there with ``python -m pytest -q
tests/test_torch_engine_trace.py``). Imports no JAX."""
import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.models import init_lm
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serve.engine import Engine, Request

PAD = 16
MODES = {
    "paged": dict(paged=True, block_size=8),
    "chunked": dict(paged=True, block_size=8, prefill_chunk=8,
                    token_budget=12),
    "prefix": dict(paged=True, block_size=8, prefix_cache=True),
}
TIMED = ("prefill", "prefill_chunk", "decode_loop")


def _engine(device="cpu", tracer=None, dtype="float32", **kw):
    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"].smoke(), dtype=dtype)
    params = init_lm(cfg, torch.Generator(device).manual_seed(0),
                     device=device)
    return Engine(cfg, params, max_slots=2, max_seq=64, pad_len=PAD,
                  steps_per_sync=4, tracer=tracer, device=device, **kw)


def _serve(eng, n=5):
    """Five requests, prompts of 4 to 20 tokens (the longest is cut to
    the bucket), the last two sharing the first's opening tokens."""
    prompts = [list(range(1, 5 + 4 * i)) for i in range(n - 2)]
    prompts += [prompts[0] + [40, 41], prompts[0] + [50]]
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(200):
        if not eng.load:
            break
        eng.step()
    assert all(r.done for r in reqs)
    return reqs


def _spans(events):
    """(name, tid, t0, t1, begin args, end args) from B/E pairs."""
    stacks, out = {}, []
    for ev in events:
        if ev["ph"] == "B":
            stacks.setdefault(ev["tid"], []).append(ev)
        elif ev["ph"] == "E":
            b = stacks[ev["tid"]].pop()
            out.append((b["name"], ev["tid"], b["ts"], ev["ts"],
                        b.get("args", {}), ev.get("args", {})))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_phases_nest_in_every_step(mode):
    tr = Tracer()
    eng = _engine(tracer=tr, **MODES[mode])
    reqs = _serve(eng)
    assert validate_chrome_trace(tr.dump()) == []
    spans = _spans(tr.events)
    steps = [s for s in spans if s[0] == "engine_step"]
    assert len(steps) == eng.steps > 0
    decoding = 0
    for _, _, t0, t1, _, _ in steps:
        kids = sorted((s for s in spans if s[1] == 0 and s[0] !=
                       "engine_step" and t0 <= s[2] <= s[3] <= t1),
                      key=lambda s: s[2])
        names = [s[0] for s in kids]
        assert names[0] == "plan" and names in (
            ["plan"], ["plan", "decode_loop", "drain"])
        assert all(a[3] <= b[2] for a, b in zip(kids, kids[1:]))
        if "decode_loop" in names:
            decoding += 1
            args = kids[1][5]
            assert args["iters"] == 4 and 1 <= args["active"] <= 2
        # the slots' prefills lie inside the step, between plan and loop
        for s in spans:
            if s[0] in ("prefill", "prefill_chunk") and t0 <= s[2] <= t1:
                assert s[1] >= 1 and kids[0][3] <= s[2] <= s[3] <= t1
    assert decoding >= 1
    # the analyzer counts a span named prefill as prefill time: none is
    # on the replica's own track
    assert not [s for s in spans if s[1] == 0 and s[0].startswith("prefill")]
    assert all(r.out for r in reqs)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_rows_and_counters(mode):
    tr = Tracer()
    eng = _engine(tracer=tr, **MODES[mode])
    _serve(eng)
    spans = _spans(tr.events)
    rows = tokens = 0
    for name, _, _, _, begin, end in spans:
        if name == "prefill":
            n = begin["tokens"]
            assert end["tokens"] == n
            assert end["rows"] == min(-(-n // PAD) * PAD, 64)
            rows, tokens = rows + end["rows"], tokens + n
        elif name == "prefill_chunk":
            rows += begin["end"] - begin["start"]
            tokens += begin["end"] - begin["start"]
    # chunks (and, with the prefix cache, every admission) run exact
    # shapes; a single-shot admission runs its whole bucket
    assert tokens > 0 and (rows > tokens) == (mode == "paged")
    st = eng.stats()
    assert (st["prefill_rows"], st["prefill_tokens"]) == (rows, tokens)
    assert not any("device_ms" in s[5] for s in spans)     # a CPU engine


@pytest.mark.parametrize("mode", list(MODES))
def test_tracing_off_leaves_nothing(mode, monkeypatch):
    made = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: made.append(name))
    off = _engine(**MODES[mode])
    assert off._phases is None and off.tracer.events == ()
    got = [r.out for r in _serve(off)]
    assert off.tracer.events == () and made == []
    monkeypatch.undo()
    on = _engine(tracer=Tracer(), **MODES[mode])
    assert [r.out for r in _serve(on)] == got
    assert on.host_syncs == off.host_syncs
    for key in ("prefill_rows", "prefill_tokens"):
        assert on.stats()[key] == off.stats()[key] > 0


def test_engine_ranges_are_host_operations():
    tr = Tracer()
    eng = _engine(tracer=tr, **MODES["chunked"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("engine.")]
    assert ranges
    assert all(not e.is_user_annotation() for e in ranges)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU
               for e in ranges)
    count = {}
    for e in ranges:
        count[e.name()] = count.get(e.name(), 0) + 1
    spans = _spans(tr.events)
    want = {}
    for s in spans:
        key = "engine." + s[0].replace("engine_", "")
        want[key] = want.get(key, 0) + 1
    assert count == want


class _Clock:
    """CUDA events on the host clock. An event records the engine's sync
    count; reading a pair asserts that the stream was synchronised after
    both were recorded (tracing must not synchronise to read them)."""

    def __init__(self):
        self.made = 0
        self.eng = None

    def event(self, enable_timing=False):
        clock = self

        class Event:
            def __init__(self):
                clock.made += 1

            def record(self, stream=None):
                self.t, self.syncs = time.perf_counter(), clock.eng.host_syncs

            def elapsed_time(self, end):
                assert clock.eng.host_syncs > end.syncs >= self.syncs
                return (end.t - self.t) * 1e3

        return Event()


@pytest.mark.parametrize("mode", ["paged", "chunked"])
def test_device_time_is_read_after_a_drain(mode, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(torch.cuda, "Event", clock.event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    tr = Tracer()
    eng = _engine(tracer=tr, **MODES[mode])
    clock.eng = eng
    eng._phases.device = torch.device("cuda")      # the stand-in's clock
    _serve(eng)
    spans = _spans(tr.events)
    timed = [s for s in spans if s[0] in TIMED]
    assert timed and all("device_ms" not in s[5] for s in spans
                         if s[0] not in TIMED)
    done = [s for s in timed if "device_ms" in s[5]]
    # the last step drains, so every span has been read by the end
    assert done == timed
    for s in done:
        assert 0 <= s[5]["device_ms"] <= (s[3] - s[2]) / 1e3 + 0.05
    # the events are recycled: no more than the busiest step holds in
    # flight (two prefills and the loop, two chunks left for a later
    # drain), far fewer than two a span
    assert clock.made <= 2 * (2 + 1) + 2 * 2 < 2 * len(timed)
    if mode == "chunked":
        # a step that only prefills a chunk leaves it to a later drain
        assert any(s[0] == "prefill_chunk" for s in done)


@pytest.mark.cuda
def test_device_time_on_the_card():
    """On the card: every timed span's device time lies within its host
    span, tracing adds no host synchronisation, the tokens are the same,
    and the ``engine.*`` ranges stay off the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    off = _engine("cuda", dtype="bfloat16", **MODES["paged"])
    got = [r.out for r in _serve(off)]
    tr = Tracer()
    on = _engine("cuda", tracer=tr, dtype="bfloat16", **MODES["paged"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert [r.out for r in _serve(on)] == got
    assert on.host_syncs == off.host_syncs
    spans = _spans(tr.events)
    timed = [s for s in spans if s[0] in TIMED]
    assert timed and all("device_ms" in s[5] for s in timed)
    for s in timed:
        assert 0 <= s[5]["device_ms"] <= (s[3] - s[2]) / 1e3 + 0.05, s
    events = prof.profiler.kineto_results.events()
    ranges = [e for e in events if e.name().startswith("engine.")]
    assert ranges and all(
        e.device_type() == torch.autograd.DeviceType.CPU
        and not e.is_user_annotation() for e in ranges)
