"""prefill_pad_share.batch: the share of the rows that the window's
single-shot prefills ran that are padding: 100 * (1 - the prefix rows
over the bucket rows), from the ``tokens`` and ``rows`` the engine puts
on each ``prefill`` span's end, over every step of the window, in
percent."""
from harness import spans


def read(run):
    if run.spans is None:
        return None
    steps = [s for s in run.steps if s.window]
    rows = tokens = 0
    for group in spans.by_step(run, steps).values():
        for sp in group:
            if sp.name == "prefill" and "rows" in sp.args:
                rows += sp.args["rows"]
                tokens += sp.args["tokens"]
    return 100.0 * (1.0 - tokens / rows) if rows else None
