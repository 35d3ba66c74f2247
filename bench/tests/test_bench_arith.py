"""The frozen arithmetic: FLOP and byte counts against hand-worked small
cases, the traffic generator, percentiles, and the window's metrics on a
loop whose engine and clock are stand-ins."""
import math

import numpy as np
import pytest

from harness import flops
from harness.serve import LoadLoop, Rec, Step
from harness.stats import percentile
from harness.traffic import Traffic, lengths
from layouts import load_layout

dense = load_layout("dense")

# D 4, 2 query heads and 1 kv head of 2, F 3, L 2, V 10
D = {"L": 2, "D": 4, "Hq": 2, "Hkv": 1, "hd": 2, "F": 3, "V": 10}


def test_layer_weights_by_hand():
    # q 4x4, k and v 4x2 each, o 4x4, gate/up 4x3, down 3x4
    assert dense.layer_weights(D) == 16 + 8 + 8 + 16 + 12 + 12 + 12


def test_prompt_flops_by_hand():
    # 3 tokens: products 2*84*2*3, pairs 6 a head and layer at 4*hd=8
    # FLOPs each over 2 heads and 2 layers, head 2*4*10 once
    assert dense.prompt_flops(D, 3) == 2 * 84 * 2 * 3 + 8 * 6 * 2 * 2 + 80


def test_decode_flops_by_hand():
    # cache 5, two tokens: they see 6 and 7 keys
    want = 2 * (2 * 84 * 2 + 80) + 8 * (6 + 7) * 2 * 2
    assert dense.decode_flops(D, 5, 2) == want


def test_decode_flops_add_up_one_token_at_a_time():
    assert dense.decode_flops(D, 9, 4) == sum(
        dense.decode_flops(D, 9 + k, 1) for k in range(4))


def test_prefill_attention_by_hand():
    f, b = dense.prefill_attention(D, 4)
    assert f == 8 * 2 * 10 * 2           # 10 causal pairs of 4 rows
    assert b == 2 * 4 * 2 * (2 * 2 + 2 * 1) * 2


def test_decode_attention_by_hand():
    f, b = dense.decode_attention(D, [3, 17], slots=4, block_size=16)
    assert f == 8 * 2 * (3 + 17) * 2
    per_layer = (2 * 4 * 2 * 2 * 2 + 4 * 4  # q, out, lengths: all slots
                 + 2 * 2 * 3 * 1 * 2 + 4 * 1 + 2 * 2 * 17 * 1 * 2 + 4 * 2)
    assert b == per_layer * 2


def test_bound_takes_the_larger():
    assert flops.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_step_attention_bound_runs_every_iteration():
    st = Step(0, 1, [3], [(3, 2), (10, 1)], 3, 5, True, True)
    want = flops.bound_s(*dense.prefill_attention(D, 8))
    want += flops.bound_s(*dense.decode_attention(D, [4, 11], 4, 16))
    want += flops.bound_s(*dense.decode_attention(D, [5], 4, 16))
    want += 2 * flops.bound_s(*dense.decode_attention(D, [], 4, 16))
    got = flops.step_attention_bound(dense, D, st, [8], 4, 16, 4)
    assert got == pytest.approx(want)


def test_mfu_work_of_a_step():
    st = Step(0, 1, [3], [(3, 2)], 3, 3, True, False)
    assert flops.step_model_flops(dense, D, st) == (
        dense.prompt_flops(D, 3) + dense.decode_flops(D, 3, 2))


MIX = {"prompt": {"dist": "lognormal", "median": 3072, "sigma": 0.6,
                  "min": 1024, "max": 8192, "block": 16},
       "output": {"dist": "lognormal", "median": 32, "sigma": 0.8,
                  "min": 8, "max": 128, "block": 16},
       "load": {"kind": "poisson", "rate_per_s": 2.0}}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_traffic_is_deterministic_and_clipped(seed):
    a, b = Traffic(MIX, seed, 131072), Traffic(MIX, seed, 131072)
    for i in range(40):
        assert a.request(i) == b.request(i)
        assert a.due(i) == b.due(i)
        assert 1024 <= a.prompt_len(i) <= 8192
        assert 8 <= a.max_new(i) <= 128
        assert all(0 <= t < 131072 for t in a.prompt(i)[:50])


def test_traffic_blocks_hold_the_same_sizes_for_every_seed():
    table = sorted(lengths(MIX["prompt"]))
    for seed in (1, 2, 3):
        t = Traffic(MIX, seed, 100)
        for blk in range(3):
            got = sorted(t.prompt_len(16 * blk + j) for j in range(16))
            assert got == table
    assert Traffic(MIX, 1, 100).prompt(0) != Traffic(MIX, 2, 100).prompt(0)


def test_traffic_ends_reach_the_clips_and_median():
    t = lengths(MIX["prompt"])
    assert min(t) == 1024 and max(t) == 8192
    assert sorted(t)[7] < 3072 < sorted(t)[8]


@pytest.mark.parametrize("seed", [5, 2**31 + 5])
def test_poisson_gaps_have_the_rate(seed):
    """The gaps are i.i.d. exponential of mean 1 / rate: their mean and
    coefficient of variation near 1/2 s and 1, no stratification left
    (the sum of any 8 consecutive gaps spreads as a gamma(8) does), and
    another seed gives other gaps."""
    t = Traffic(MIX, seed, 100)
    n = 4000
    gaps = np.diff([t.due(i) for i in range(n + 1)])
    assert gaps.min() > 0
    assert gaps.mean() == pytest.approx(0.5, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.06)
    blocks = gaps.reshape(-1, 8).sum(axis=1)
    assert blocks.std() / blocks.mean() == pytest.approx(8 ** -0.5, rel=0.1)
    assert Traffic(MIX, seed + 1, 100).due(5) != t.due(5)


def test_percentile_interpolates():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile([0, 10], 90) == pytest.approx(9.0)
    assert percentile(list(range(11)), 90) == pytest.approx(9.0)


# ------------------------------------------------- window on a stand-in
class _Eng:
    """Admits every queued request at once; each step gives each running
    request up to ``per_step`` tokens."""

    def __init__(self, per_step=3, slots=2):
        self.queue, self.running, self.per_step = [], [], per_step
        self.slots = slots

    @property
    def load(self):
        return len(self.queue) + len(self.running)

    def submit(self, req):
        self.queue.append(req)

    def step(self):
        while self.queue and len(self.running) < self.slots:
            r = self.queue.pop(0)
            r.out.append(0)
            self.running.append(r)
        for r in self.running:
            n = min(self.per_step, r.max_new + 1 - len(r.out))
            r.out.extend([1] * n)
            r.done = len(r.out) > r.max_new
        self.running = [r for r in self.running if not r.done]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class _Traffic:
    def request(self, i):
        return [1, 2, 3, 4][: 2 + i % 3], 4

    def due(self, i):
        return 0.5 * i


def test_backlog_window_is_whole_steps():
    eng = _Eng()
    drv = LoadLoop(eng, _Traffic(), {"max_slots": 2, "pad_len": 4,
                                     "max_seq": 16}, 3.0, clock=_Clock())
    drv.run_backlog(1)
    w = [s for s in drv.steps if s.window]
    assert drv.window == (w[0].t0, w[-1].t1)
    assert w[-1].t1 - w[0].t0 >= 3.0 > w[-2].t1 - w[0].t0
    # every token served is counted once, every prompt at its admission
    assert sum(s.out_tokens for s in drv.steps) == sum(
        len(r.req.out) for r in drv.recs)
    ends = {s.t1 for s in w}
    assert sum(s.prompt_tokens for s in w) == sum(
        r.prompt_len for r in drv.recs if r.t_first in ends)
    first = next(s for s in drv.steps if s.admitted)
    assert first.decode == [(n, 3) for n in first.admitted]
    view = type("V", (), {"steps": drv.steps, "window": drv.window})()
    assert _metric("tokens_per_s")(view) == pytest.approx(
        sum(s.prompt_tokens + s.out_tokens for s in w)
        / (w[-1].t1 - w[0].t0))


def _metric(name):
    from harness.spec import reader
    return reader(name)


class _View:
    def __init__(self, recs, stop, window=(0.0, 10.0)):
        self.recs, self.window = recs, window
        self.loop = type("D", (), {"stop": stop})()


def _rec(i, due, first, last=None, n=0, window=True):
    r = Rec(i, None, 10, due, window)
    r.t_first, r.t_last, r.n_last = first, last, n
    return r


def test_ttft_is_censored_at_stop():
    recs = [_rec(i, due=float(i), first=float(i) + 1.0) for i in range(9)]
    recs.append(_rec(9, due=9.0, first=None))          # never answered
    recs.append(_rec(10, due=1.0, first=2.0, window=False))
    got = _metric("ttft_p90_ms")(_View(recs, stop=20.0))
    # nine of 1000 ms and one of (20 - 9) s: p90 between the two
    assert got == pytest.approx(1000 + 0.1 * (11000 - 1000))


def test_tpot_counts_tokens_after_the_first():
    recs = [_rec(0, 0.0, 1.0, last=3.0, n=5),          # 500 ms
            _rec(1, 0.0, 1.0, last=1.0, n=9),          # all in one step
            _rec(2, 0.0, 1.0, last=1.0, n=1)]          # one token: left out
    got = _metric("tpot_p90_ms")(_View(recs, stop=5.0))
    assert got == pytest.approx(0.0 + 0.9 * 500.0)
