"""The window's wall time, up to the last unit completed, over the train steps
completed in it: a whole-window rate on the host clock."""

UNIT = "s"
BETTER = "lower"


def read(ctx):
    if not ctx.window_units or ctx.window_s <= 0:
        return None
    return ctx.window_s / ctx.window_units
