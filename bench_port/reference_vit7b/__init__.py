# Frozen copy of genpose2_tpu_torch/__init__.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""PyTorch/CUDA port of genpose2_tpu for one NVIDIA H100.

The package mirrors the JAX package's module layout. It imports neither JAX
nor anything of ``genpose2_tpu``; what it needs from there (the config tree)
is a copy of its own. Every Pallas kernel on the ported path is a CUDA C++
kernel under ``ops/csrc/``, built by ``nvcc`` at first use (``ops/_cuda.py``).

Entry points: ``api.GenPose2`` (frames), ``eval/`` (evaluation and
tracking), ``training/`` (the agents and the ``Trainer``), ``cli`` (train,
eval and track from files on disk; data-parallel training over
``parallel/``) and ``demo``. ROADMAP.md says what is deliberately not
ported.
"""
