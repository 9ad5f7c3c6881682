"""Seconds the program spent in ``_cuda.library`` building (``nvcc``) or
loading its kernel libraries, over the run's set-up."""

from bench_port.harness.program import process_counter


def read(ctx):
    return process_counter(ctx, "kernel_load_s")
