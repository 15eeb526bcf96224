"""The device's idle share of the traced window: the time in which no
operation ran on the card (the union of the device records' intervals
left out), over the window, from the profiler's raw records."""

UNIT = "%"


def read(run):
    t = run.trace
    if not t.busy_ns:
        return None
    return 100.0 * (t.window_ns - t.busy_ns) / t.window_ns
