"""Reads of device tensors by the host (``profiling.to_host``) inside the
program's ``eval.batch`` spans of the traced window, a batch."""

from bench_port.harness.program import per_unit


def read(ctx):
    return per_unit(ctx, "host_reads")
