"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from layouts import layout_of

from . import system
from .profile import SliceProfiler, load_classes
from .serve import LoadLoop
from .spec import BENCH, Cell, reader
from .traffic import Traffic

PROFILE_AT = 0.3          # the traced slice starts this far into the window
PROFILE_S = 5.0           # and runs whole steps for at least this long


@dataclasses.dataclass
class RunView:
    """What a metric's reader sees: with the run's records, the model's
    layout module (``bench/layouts/<layout>.py``) and its ``dims``."""
    cell: Cell
    layout: object
    d: dict
    engine: dict
    setup_s: float
    loop: LoadLoop
    trace: object = None          # profile.Trace of the traced slice
    spans: Optional[list] = None  # the engine's Tracer events

    @property
    def steps(self):
        return self.loop.steps

    @property
    def recs(self):
        return self.loop.recs

    @property
    def window(self):
        return self.loop.window


def _sample(loop: LoadLoop, load: str, k: int, seed: int) -> List:
    """The finished requests the reference checks: the one with the most
    served tokens, the one with the longest prompt, and others drawn from
    the seed, ``k`` in all."""
    w0, w1 = loop.window
    if load == "poisson":
        done = [r for r in loop.recs if r.window and r.req.done]
    else:
        done = [r for r in loop.recs if r.req.done and w0 <= r.t_done <= w1]
    if not done:
        return []
    pick = [max(done, key=lambda r: (len(r.req.out), r.prompt_len)),
            max(done, key=lambda r: (r.prompt_len, len(r.req.out)))]
    rest = [r for r in done if r not in pick]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 128), 9]))
    extra = rng.choice(len(rest), size=min(k - 2, len(rest)), replace=False)
    pick += [rest[i] for i in sorted(extra)]
    uniq = []
    for r in pick:
        if r not in uniq:
            uniq.append(r)
    return uniq


def _counts(loop: LoadLoop, load: str):
    if load == "poisson":
        due = [r for r in loop.recs if r.window]
        failed = sum(1 for r in due if r.t_first is None
                     or r.t_first > loop.stop or not r.req.done)
        return len(due), failed
    return sum(len(s.admitted) for s in loop.steps if s.window), 0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, log=lambda s: print(s, file=sys.stderr),
        control: bool = False) -> dict:
    """One run; with ``control`` the reference also computes the
    comparison's control (``reference.<layout>``'s), whose widest gap
    goes through the same checks and comes back under ``control`` with its
    own ``correct`` (the benchmark's own runs never ask)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    lay = layout_of(cell.config)
    d = lay.dims(cell.config)
    load = cell.traffic["load"]
    mcfg = system.model_config(cell.config)
    t_params = time.perf_counter()
    params = system.make_params(cell.config, mcfg, seed, device)
    sync()
    log(f"set-up: process to weights {t_params - t_process:.2f} s, "
        f"weights {time.perf_counter() - t_params:.2f} s")
    tracer = system.make_tracer() if trace else None
    eng = system.make_engine(mcfg, params, cell.engine, device, tracer)
    traffic = Traffic(cell.traffic, seed, d["V"])
    prof = None
    loop = LoadLoop(eng, traffic, cell.engine, seconds)
    if trace and cuda:
        prof = SliceProfiler(lambda: loop.t_open + PROFILE_AT * seconds,
                             PROFILE_S, sync)
        loop.on_boundary = prof.boundary
    if load["kind"] == "backlog":
        loop.run_backlog(load["warm_steps"])
    else:
        loop.run_poisson(load["warmup_s"])
    sync()
    setup_s = loop.window[0] - t_process
    pre = [s for s in loop.steps if s.t1 <= loop.window[0]]
    log(f"set-up: {len(pre)} engine steps before the window, "
        f"{sum(s.t1 - s.t0 for s in pre):.2f} s")
    win = [s for s in loop.steps if s.window]
    log(f"window: {len(win)} engine steps, "
        f"{sum(len(s.admitted) for s in win)} admissions, "
        f"{sum(s.prompt_tokens for s in win)} prompt and "
        f"{sum(s.out_tokens for s in win)} output tokens, "
        f"{loop.window[1] - loop.window[0]!r} s")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if eng.sched.preemptions:
        log(f"note: {eng.sched.preemptions} preemptions")
    view = RunView(cell, lay, d, cell.engine, setup_s, loop,
                   spans=tracer.events if tracer is not None else None)
    if prof is not None:
        view.trace = prof.reduce(load_classes(BENCH / "kernel_classes"))
        if view.trace is not None:
            for cls, sec in sorted(view.trace.by_class.items()):
                log(f"trace: class {cls} {sec!r} s")
            for name in view.trace.unclassified:
                log(f"unclassified kernel: {name} "
                    f"{view.trace.by_name[name]!r} s")
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(view)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = _counts(loop, load["kind"])
    lim = cell.limits["logit_gap"]
    picked = _sample(loop, load["kind"], lim["sample"], seed)
    served = [(r.req.prompt, list(r.req.out)) for r in picked]
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else
                device.type, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev_info}
    if view.trace is not None:
        dev_info["busy_s"] = view.trace.busy_s
        dev_info["window_s"] = view.trace.slice_s
        out["breakdown"] = {
            "device_ops": sorted(view.trace.by_name.items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": view.trace.gaps[:10]}
    # The program's state goes before the reference runs.
    del eng, params, loop.eng, view, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gap, ctl = _widest_gap(cell.config, seed, served, device, control)
    log(f"reference: {len(served)} requests, "
        f"{sum(len(o) for _, o in served)} served tokens, "
        f"{time.perf_counter() - t_ref:.1f} s")
    checks = _checks(gap, failed, lim["limit"])
    out["correct"] = _correct(checks, served)
    out["checks"] = checks
    if control:
        ctl_checks = _checks(ctl, failed, lim["limit"])
        out["control"] = {"correct": _correct(ctl_checks, served),
                          "checks": ctl_checks}
        out["served"] = [sum(len(o) for _, o in served),
                         len({t for _, o in served for t in o})]
    return out


def _checks(gap, failed: int, limit: float) -> dict:
    return {"logit_gap": {"value": gap, "limit": limit},
            "failed": {"value": failed, "limit": 0}}


def _correct(checks: dict, served) -> bool:
    return bool(served) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())


def _widest_gap(cfg: dict, seed: int, served, device, control: bool):
    """The widest gap of a served token under the layout's reference
    (``reference.<layout>``), and with ``control`` the widest gap of the
    control's own first choices."""
    if not served:
        return None, None
    ref = importlib.import_module(f"reference.{cfg['layout']}")
    res = ref.served_gaps(cfg, seed, served, device, control)
    widest = lambda gs: max(max(g) for g in gs)
    return widest(res["gap"]), widest(res["control"]) if control else None
