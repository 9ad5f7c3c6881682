"""The wide-row route of the LayerNorm kernel in bf16 (layernorm.cu
``ln_wide_kernel<__nv_bfloat16, ...>``, from ``fast_add_layernorm`` at 4,096:
each ViT block's layer-scaled residual and norm2): its least time at the
cell's rows (``harness/vit_costs.py``) over its device time a launch."""

from bench_port.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, r"\bln_wide_kernel<__nv_bfloat16\b", "add_layernorm")
