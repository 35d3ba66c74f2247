"""decode_iter_ms.batch: device milliseconds of one decode iteration:
the ``device_ms`` of the engine's ``decode_loop`` spans (its uploads, the
``steps_per_sync`` iterations over every slot, up to the drain's copy)
over their ``iters``, summed over the window's steps outside the
profiled slice."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    ms = iters = 0.0
    for group in spans.by_step(run, spans.timed_steps(run)).values():
        for sp in group:
            if sp.name == "decode_loop" and "device_ms" in sp.args:
                ms += sp.args["device_ms"]
                iters += sp.args["iters"]
    return ms / iters if iters else None
