"""mfu.batch: model FLOPs of the work done in the window's steps outside
the profiled slice (the layout's counts through ``harness.flops``:
products of the non-embedding weights, causal attention, the head where
a token is sampled) over their seconds times the bf16 peak, in
percent."""
from harness import flops


def read(run):
    steps = [s for s in run.steps if s.window and not s.profiled]
    if not steps:
        return None
    work = sum(flops.step_model_flops(run.layout, run.d, s) for s in steps)
    secs = sum(s.t1 - s.t0 for s in steps)
    return 100.0 * work / (secs * flops.PEAK_BF16_FLOPS)
