"""moe_gmm_roofline.batch: the ``gmm`` calls of the profiled slice, the
least time they could take, over the device time of the kernels whose
name carries ``gmm``, in percent. The work is read per phase span from
the engine's MoE load (the ``moe_rows`` and ``moe_experts_hit`` end args
of the ``prefill`` and ``decode_loop`` spans of the profiled steps,
summed over layers and calls) through the layout's ``gmm_work``: three
products of 2 x rows x D x Fe FLOPs; each hit expert's three matrices
read once a call, each row's inputs read and outputs written once.
Nothing without the spans, their args, or a ``gmm`` kernel."""
from harness import flops, spans

KERNEL = "gmm"
PHASES = ("prefill", "decode_loop")


def read(run):
    if run.trace is None or run.spans is None:
        return None
    work = getattr(run.layout, "gmm_work", None)
    spent = sum(sec for name, sec in run.trace.by_name.items()
                if KERNEL in name)
    steps = [s for s in run.steps if s.profiled]
    if work is None or spent <= 0 or not steps:
        return None
    bound = 0.0
    for group in spans.by_step(run, steps).values():
        for sp in group:
            if sp.name not in PHASES:
                continue
            if "moe_rows" not in sp.args:
                return None
            bound += flops.bound_s(*work(run.d, sp.args["moe_rows"],
                                         sp.args["moe_experts_hit"]))
    return 100.0 * bound / spent if bound > 0 else None
