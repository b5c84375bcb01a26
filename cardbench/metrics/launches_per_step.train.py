"""launches_per_step.train: kernel launches in the traced steps (copies and
sets left out) over the number of steps: the host's dispatch work a step."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return ctx["trace"].launches / ctx["steps"]
