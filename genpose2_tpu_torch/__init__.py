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
