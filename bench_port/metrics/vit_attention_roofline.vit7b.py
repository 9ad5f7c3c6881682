"""The bf16 ViT attention kernel at head dim 128 (vit_attention.cu
``vit_attention_bf16_kernel<128, ...>``, from ``vit_attention_tm``): its least
time at the cell's shape (128 crops, 32 heads, 261 real tokens of 272;
``harness/vit_costs.py``) over its device time a launch."""

from bench_port.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, r"\bvit_attention_bf16_kernel<128\b", "vit_attention")
