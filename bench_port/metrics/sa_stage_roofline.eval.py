"""The SA stage kernel (fused_sa.cu ``sa_kernel`` over several scales, from
``gp2_sa_stage``): its least time at each launch's shapes and grouped rows
over its device time a launch."""

from bench_port.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, r"\bsa_kernel<[^,]+, *([2-9]|\d\d+), *false", "sa_stage")
