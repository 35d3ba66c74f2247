"""device_idle.batch: the share of the profiled slice (whole engine steps)
in which no operation ran on the device, in percent."""


def read(run):
    t = run.trace
    if t is None or t.slice_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.slice_s)
