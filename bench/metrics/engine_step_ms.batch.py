"""engine_step_ms.batch: host milliseconds of one Engine.step (admission,
prefill, the decode loop and its drain), the window's steps outside the
profiled slice: their seconds over their count."""


def read(run):
    steps = [s for s in run.steps if s.window and not s.profiled]
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
