"""attn_roofline.batch: the attention calls of the profiled slice, the
least time they could take by ``harness.flops`` (each call the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth; a prefill at the
rows its ``prefill`` span says it launched), over the device time of the
kernels of the ``attention`` class, in percent. Nothing where the engine
does not report the rows."""
from harness import flops, spans


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.by_class.get("attention", 0.0)
    steps = [s for s in run.steps if s.profiled]
    if spent <= 0 or not steps:
        return None
    rows = spans.prefill_rows(run, steps)
    if rows is None:
        return None
    e = run.engine
    bound = sum(flops.step_attention_bound(run.layout, run.d, s, r,
                                           e["max_slots"], e["block_size"],
                                           e["steps_per_sync"])
                for s, r in zip(steps, rows))
    return 100.0 * bound / spent
