"""The fused RK4 kernel (ode_rk4.cu ``rk4_kernel``): its least time at the
unit's rows, steps and widths over its device time a launch."""

from bench_port.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, r"\brk4_kernel\b", "rk4")
