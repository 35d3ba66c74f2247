"""The port's SLO monitor, flight recorder and trace analyzer against the
JAX package's.

Held exactly: the SLO monitor's alerts, attainment, snapshot and report
lines over one stream of explicitly timed observations; the flight
recorder's ``dump()`` over one event stream at every capacity from 1 to
64 (both trace clocks replaced by one counter); the analyzer's whole
result (``asdict``), its invariants, renderings and CLI exit codes on
the same trace file. The trace is the port's own, written by a
migrating, crashing, predictive fabric, and the reference analyzer must
attribute every request in it (residual at most 1%) and stitch the
migrated ones across replicas.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro.obs.analyze as j_analyze
from repro.obs import FlightRecorder as JFlightRecorder
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import SLOMonitor as JSLOMonitor
from repro.obs import SLOTarget as JSLOTarget
from repro.obs import Tracer as JTracer
from repro_torch.obs import (FlightRecorder, MetricsRegistry, SLOMonitor,
                             SLOTarget, Tracer, validate_chrome_trace)
from repro_torch.obs import analyze as t_analyze
from repro_torch.serve import CostModel, FaultInjector
from test_torch_migrate import FABRIC_PROMPTS, Side

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ------------------------------------------------------------ SLO monitor
def slo_stream(jax_side: bool):
    """The reference's burn-alert scenario: healthy, then a sustained 50%
    violation rate (one alert), then recovery (one clear), all at
    explicit timestamps."""
    T, M, R, Tr = ((JSLOTarget, JSLOMonitor, JMetricsRegistry, JTracer)
                   if jax_side else
                   (SLOTarget, SLOMonitor, MetricsRegistry, Tracer))
    tr, reg = Tr(), R()
    m = M([T("ttft_ms", 100.0, 0.99), T("tpot_ms", 5.0, 0.9)],
          windows=((60.0, 5.0, 10.0),), tracer=tr,
          metrics=reg, pid=9)
    t0, log = 1e6, []
    for i in range(100):
        m.observe("ttft_ms", 10.0, ts_us=t0 + i * 1e4)
        m.observe("tpot_ms", 4.0 + (i % 7 == 0), ts_us=t0 + i * 1e4)
    log.append(m.check(ts_us=t0 + 1e6))
    for i in range(100):
        m.observe("ttft_ms", 500.0 if i % 2 else 10.0,
                  ts_us=t0 + 2e6 + i * 1e4)
    log += [m.check(ts_us=t0 + 3e6), m.check(ts_us=t0 + 3.1e6)]
    for i in range(600):
        m.observe("ttft_ms", 10.0, ts_us=t0 + 4e6 + i * 1e4)
    m.observe("queue_wait_ms", 1e9, ts_us=t0 + 9e6)     # undeclared
    log.append(m.check(ts_us=t0 + 10e6))
    events = [(e["name"], e["pid"], e.get("args")) for e in tr.events
              if e.get("ph") == "i"]
    return (log, m.alerts_fired, m.attainment(), m.snapshot(),
            m.report_lines(), events, reg.snapshot(),
            m.target_ms("ttft_ms"), m.target_ms("queue_wait_ms"))


def test_slo_monitor_matches_jax():
    got = slo_stream(False)
    assert got == slo_stream(True)
    log, fired, _, _, _, events, _, _, _ = got
    assert log == [[], ["ttft_ms"], ["ttft_ms"], []] and fired == 1
    assert [e[0] for e in events] == ["slo_burn", "slo_burn_clear"]


# --------------------------------------------------------- flight recorder
class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.5
        return self.t


def emit(tr):
    """A mixed event stream: nested spans, request lifecycles with a
    preemption and a cross-replica migration, instants, counters, and a
    span still open at dump time."""
    tr.process_name(0, "replica 0")
    tr.process_name(1, "replica 1")
    tr.thread_name(0, 0, "engine")
    for rid in range(4):
        tr.req_begin(rid, pid=0, args={"prompt_tokens": 5})
        tr.req_phase(rid, "queued", pid=0)
    for step in range(8):
        tr.begin("engine_step", pid=0, args={"step": step})
        tr.begin("prefill", pid=0, tid=1 + step % 2)
        tr.end(pid=0, tid=1 + step % 2)
        tr.end(pid=0)
        tr.counter("load", {"running": float(step)}, pid=0)
    tr.req_phase(0, "prefill", pid=0)
    tr.req_phase(0, "decode", pid=0)
    tr.req_instant(1, "preempted", pid=0)
    tr.req_phase(1, "queued", pid=0)
    tr.req_instant(0, "migrated_out", pid=0, args={"bytes": 4096})
    tr.req_phase(0, "migrate", pid=0)
    tr.req_instant(0, "migrated_in", pid=1, args={"mode": "live"})
    tr.req_phase(0, "decode", pid=1)
    tr.req_end(0, pid=1, args={"tokens": 9})
    tr.req_end(1, pid=0)
    tr.instant("steal_queued", pid=2, args={"n": 2})
    tr.begin("superstep", pid=2)        # left open at dump time


def test_flight_dump_matches_jax_at_every_capacity(monkeypatch):
    clock = Clock()
    for mod in ("repro.obs.trace", "repro.obs.flight",
                "repro_torch.obs.trace", "repro_torch.obs.flight"):
        monkeypatch.setattr(f"{mod}.now_us", clock)
    for capacity in range(1, 65):
        dumps = []
        for FR in (FlightRecorder, JFlightRecorder):
            clock.t = 1000.0
            fr = FR(capacity=capacity)
            emit(fr)
            dump = fr.dump()
            # the wall-clock anchor is read from the host, not the clock
            assert dump["otherData"].pop("clock_sync")
            dumps.append((dump, fr.dropped, len(fr.events)))
        assert dumps[0] == dumps[1], capacity
        assert validate_chrome_trace(dumps[0][0]) == []
        assert dumps[0][0]["otherData"]["flight"]["capacity"] == capacity
    for bad in (0, -5):
        with pytest.raises(ValueError):
            FlightRecorder(capacity=bad)


def test_flight_write_is_atomic_and_non_destructive(tmp_path):
    fr = FlightRecorder(capacity=16)
    emit(fr)
    first = fr.dump()
    path = tmp_path / "flight.json"
    fr.write(str(path))
    loaded = json.loads(path.read_text())
    assert validate_chrome_trace(loaded) == []
    assert loaded["otherData"]["flight"]["dropped"] == fr.dropped > 0
    assert len(fr.dump()["traceEvents"]) == len(first["traceEvents"])
    assert not list(tmp_path.glob(".trace.*"))


# ---------------------------------------------------------------- analyzer
@pytest.fixture(scope="module")
def fabric_trace(tmp_path_factory):
    """The port's trace of a 3-replica fabric that migrates live
    sequences, balances predictively and loses replica 2 at superstep
    3 (its requests re-admitted)."""
    side = Side(False)
    tr = Tracer()
    engines = [side.engine(replica_id=i, tracer=tr, paged=True,
                           block_size=8) for i in range(3)]
    bal = side.balancer(engines, migrate=True, tracer=tr,
                        cost_model=CostModel(), predictive=True,
                        faults=FaultInjector().crash(2, at=3))
    reqs = [side.R(rid=i, prompt=list(FABRIC_PROMPTS[i]),
                   max_new=14 + 3 * i, tenant=f"t{i % 2}")
            for i in range(7)]
    for r in reqs:
        bal.submit(r, rr=0)
    engines[0].step()
    assert bal.run(max_steps=300) == "terminated"
    assert all(r.done for r in reqs)
    assert bal.migrations >= 1 and bal.replicas_dead == 1
    path = tmp_path_factory.mktemp("trace") / "fabric.json"
    tr.write(str(path))
    return str(path), bal


def test_analyzer_matches_the_reference_on_the_ports_trace(fabric_trace):
    path, bal = fabric_trace
    got, ref = t_analyze.analyze_trace(path), j_analyze.analyze_trace(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert t_analyze.check_invariants(got) == j_analyze.check_invariants(
        ref) == []
    assert t_analyze.render_markdown(got) == j_analyze.render_markdown(ref)
    assert t_analyze.render_summary(got) == j_analyze.render_summary(ref)
    assert t_analyze.headline(got) == j_analyze.headline(ref)
    # the reference attributes every request of the port's trace
    assert len(ref.requests) == 7 and ref.validator_problems == []
    assert all(r.unattributed_frac <= 0.01 for r in ref.requests)
    migrated = [r for r in ref.requests if r.migrations]
    assert migrated and all(len(r.replicas) > 1 for r in migrated)
    assert ref.steal.tier2_moves == sum(d[0] == "live"
                                        for d in bal.decisions)
    assert ref.steal.replicas_dead == 1
    assert ref.steal.readmissions == (bal.readmitted_queued
                                      + bal.readmitted_running)
    assert ref.prediction.samples == 7


def test_analyzer_clis_give_the_same_exit_codes(fabric_trace, tmp_path):
    path, _ = fabric_trace
    trace = json.loads(open(path).read())
    drop = next(i for i, e in enumerate(trace["traceEvents"])
                if e.get("ph") == "e")
    del trace["traceEvents"][drop]             # an async close goes
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(trace))
    for p, want in ((path, 0), (str(bad), 1)):
        for args in ([p], [p, "--json"]):
            assert t_analyze.main(args) == j_analyze.main(args) == want
    # the port's module entry point, in an interpreter without JAX
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for p, want in ((path, 0), (str(bad), 1)):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.analyze", p],
            cwd=SRC, env=env, capture_output=True, text=True)
        assert proc.returncode == want, proc.stderr
        assert "Trace analysis" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; import repro_torch.obs.analyze as a; "
         "rc = a.main(sys.argv[1:]); "
         "sys.exit(3 if 'jax' in sys.modules else rc)", path],
        cwd=SRC, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
