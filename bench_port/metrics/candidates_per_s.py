"""Objects x K candidates of every unit completed in the window, over the
window's seconds."""

from bench_port.harness.readers import work_rate


def read(ctx):
    return work_rate(ctx, "candidates")
