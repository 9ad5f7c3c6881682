"""The caching allocator's segment allocations (``cudaMalloc`` calls) inside
the program's ``eval.batch`` spans of the traced window, a batch."""

from bench_port.harness.program import per_unit


def read(ctx):
    return per_unit(ctx, "cuda_mallocs")
