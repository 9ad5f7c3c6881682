# Frozen copy of genpose2_tpu_torch/models/__init__.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
