"""GB of frozen-backbone parameters the program's agents hold on the device
(``profiling`` counter ``backbone_weight_bytes``, summed over the agents as
they are built)."""

from bench_port.harness.program import process_counter


def read(ctx):
    n = process_counter(ctx, "backbone_weight_bytes")
    return None if n is None else n / 1e9
