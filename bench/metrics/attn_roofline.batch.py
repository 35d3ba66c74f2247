"""attn_roofline.batch: the attention calls of the profiled slice, the
least time they could take by ``harness.flops`` (each call the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth), over the device
time of the kernels of the ``attention`` class, in percent."""
from harness import flops


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.by_class.get("attention", 0.0)
    steps = [s for s in run.steps if s.profiled]
    if spent <= 0 or not steps:
        return None
    e = run.engine
    bound = sum(flops.step_attention_bound(run.d, s, e["max_slots"],
                                           e["block_size"],
                                           e["steps_per_sync"])
                for s in steps)
    return 100.0 * bound / spent
