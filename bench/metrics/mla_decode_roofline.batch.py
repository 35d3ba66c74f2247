"""mla_decode_roofline.batch: the latent decode calls of the profiled
slice, the least time they could take (the layout's
``decode_attention`` for each decode iteration of the profiled steps,
summed by ``harness.flops.step_attention_bound`` with no prefill rows:
the larger of FLOPs over the bf16 peak and bytes over HBM bandwidth),
over the device time of the kernels whose name carries
``mla_paged_decode``, in percent. Nothing where no such kernel ran."""
from harness import flops

KERNEL = "mla_paged_decode"


def read(run):
    if run.trace is None:
        return None
    spent = sum(sec for name, sec in run.trace.by_name.items()
                if KERNEL in name)
    steps = [s for s in run.steps if s.profiled]
    if spent <= 0 or not steps:
        return None
    e = run.engine
    bound = sum(flops.step_attention_bound(run.layout, run.d, s, [],
                                           e["max_slots"], e["block_size"],
                                           e["steps_per_sync"])
                for s in steps)
    return 100.0 * bound / spent
