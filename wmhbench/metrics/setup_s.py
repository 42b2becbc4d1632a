"""Process start to the first timed unit on the host clock: loading,
building, inputs and weights, warm-up, and any checked steps run before
the window."""

UNIT = "s"
BETTER = "lower"


def read(ctx):
    return ctx.setup_s
