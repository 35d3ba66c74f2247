"""setup_s: seconds from the process's start to the window's opening
(kernels built or loaded, weights made on the card, the engine filled
and brought to steady state)."""


def read(run):
    return run.setup_s
