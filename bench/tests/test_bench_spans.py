"""The readers of the engine's own spans (``harness.spans``): hand-worked
values on a made-up trace, nothing from a trace without the spans or
arguments they read (as a program without them gives), the attention
bound at the rows the ``prefill`` spans report, and, on a tiny traced
run, those rows against the engine's padding rule."""
from types import SimpleNamespace

import pytest

from benchtiny import tiny_cell
from harness import runner, spans
from harness.serve import Step
from harness.spec import reader
from layouts import load_layout

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
    """On the CPU the spans carry no device time. Each ``prefill`` span's
    ``rows`` follow the engine's rule for a dense prefix (its tokens, the
    prompt cut to ``pad_len``, padded to a multiple of the block size);
    the padding share is the one those spans give; and the step's self
    time is part of the step."""
    views = []

    class Keep(runner.RunView):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            views.append(self)

    monkeypatch.setattr(runner, "RunView", Keep)
    cell = tiny_cell("backlog")
    out = runner.run(cell, SEED, 1.5, True, "cpu", 0.0, log=lambda s: None)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "prefill_ms.batch" not in m and "decode_iter_ms.batch" not in m
    view, e = views[0], cell.engine
    steps = [s for s in view.steps if s.window]
    rows = spans.prefill_rows(view, steps)
    pre = [sp for g in spans.by_step(view, steps).values() for sp in g
           if sp.name == "prefill"]
    assert pre and len(pre) == sum(len(r) for r in rows)
    assert sum(len(s.admitted) for s in steps) <= len(pre)
    prompt = {r.i: r.prompt_len for r in view.recs}
    seen = set()
    for sp in pre:
        n = sp.args["tokens"]
        if sp.args["rid"] not in seen:
            seen.add(sp.args["rid"])
            assert n == min(prompt[sp.args["rid"]], e["pad_len"])
        block = e["block_size"]
        assert sp.args["rows"] == min(-(-n // block) * block, e["max_seq"])
    want = 100.0 * (1 - sum(sp.args["tokens"] for sp in pre)
                    / sum(sp.args["rows"] for sp in pre))
    assert m["prefill_pad_share.batch"] == pytest.approx(want)
    assert 0 < m["step_host_ms.batch"] < m["engine_step_ms.batch"]


# D 4, 2 query heads and 1 kv head of 2, F 3, L 2, V 10
D = {"L": 2, "D": 4, "Hq": 2, "Hkv": 1, "hd": 2, "F": 3, "V": 10}
ENGINE = {"max_slots": 4, "block_size": 16, "steps_per_sync": 2}


def _roofline_run(rows=True, spent=1e-6):
    """Two profiled steps: the first prefills a prompt of 5 tokens into 16
    rows and decodes two slots; the second decodes one slot."""
    ev = []
    end = {"tokens": 5, **({"rows": 16} if rows else {})}
    _span(ev, "prefill", 1, 0.1, 0.2, {"rid": 0, "tokens": 5}, end)
    steps = [Step(0.0, 0.5, [5], [(5, 2), (30, 1)], 5, 3, True, True),
             Step(0.6, 0.9, [], [(31, 1)], 0, 1, True, True)]
    return SimpleNamespace(
        spans=ev, steps=steps, layout=load_layout("dense"), d=D,
        engine=ENGINE, trace=SimpleNamespace(by_class={"attention": spent}))


def test_attention_bound_reads_the_launched_rows():
    """By hand: prefill of 16 rows, 4 * hd * Hq * 16 * 17 / 2 FLOPs and
    2 B * 16 rows * hd * (2 Hq + 2 Hkv) of q, k, v, out, each over L
    layers; then per decode iteration 4 * hd * Hq FLOPs a key, and 2 B of
    q and of out per slot, query head and head dim, 4 B of length per
    slot, 2 B of k and of v per key, kv head and head dim, 4 B per block
    of each active slot's table."""
    flops_pre = 4 * 2 * 2 * (16 * 17 / 2) * 2                   # 2176
    bytes_pre = 2 * 16 * 2 * (2 * 2 + 2 * 1) * 2                 # 768
    fixed = 2 * 4 * 2 * 2 * 2 + 4 * 4                            # 80

    def it(wins):
        f = sum(4 * 2 * 2 * w for w in wins) * 2
        b = (fixed + sum(2 * 2 * w * 1 * 2 + 4 * -(-w // 16)
                         for w in wins)) * 2
        return max(f / 989e12, b / 3.35e12)

    want = max(flops_pre / 989e12, bytes_pre / 3.35e12)
    want += it([6, 31]) + it([7])                    # step 1, 2 iterations
    want += it([32]) + it([])                        # step 2
    got = reader("attn_roofline.batch")(_roofline_run(spent=1e-6))
    assert got == pytest.approx(100.0 * want / 1e-6)


@pytest.mark.parametrize("case", ["no spans", "no rows", "a chunk",
                                  "a lost span"])
def test_attention_bound_without_the_rows_gives_none(case):
    run = _roofline_run(rows=case != "no rows")
    if case == "no spans":
        run.spans = None
    elif case == "a chunk":
        _span(run.spans, "prefill_chunk", 2, 0.7, 0.8, {"rid": 1})
    elif case == "a lost span":
        run.steps[1].admitted.append(9)
    assert reader("attn_roofline.batch")(run) is None
