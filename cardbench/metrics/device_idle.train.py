"""device_idle.train: the share (%) of the traced window in which no
operation ran on the card (the union of the device intervals is busy)."""


def read(ctx):
    trace = ctx["trace"]
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
