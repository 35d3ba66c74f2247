"""tokens_per_s: every prompt token prefilled plus every output token
emitted in the window's engine steps, over those steps' seconds (the
window is whole steps, back to back)."""


def read(run):
    steps = [s for s in run.steps if s.window]
    if not steps:
        return None
    w0, w1 = run.window
    return sum(s.prompt_tokens + s.out_tokens for s in steps) / (w1 - w0)
