"""The share of the traced slice in which no kernel, copy or set ran on
the device: 1 - busy / slice."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 1.0 - s.busy_s / s.window_s
