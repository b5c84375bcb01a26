"""step_device_ms.train: the card's busy time a training step (ms), the
union of its operations' intervals over the traced steps."""


def read(ctx):
    if not ctx["steps"] or ctx["trace"].busy_s <= 0:
        return None
    return 1e3 * ctx["trace"].busy_s / ctx["steps"]
