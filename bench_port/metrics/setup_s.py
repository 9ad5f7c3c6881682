"""Set-up: process start to the first timed call (imports, kernel build or
cache load, weights, inputs, warm-up)."""

def read(ctx):
    return ctx.setup_s
