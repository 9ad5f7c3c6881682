# Frozen copy of genpose2_tpu_torch/diffusion/__init__.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
from bench_port.reference.diffusion.losses import dsm_loss, edm_loss
from bench_port.reference.diffusion.samplers import (edm_sampler, ode_likelihood, ode_sampler,
                                                   pc_sampler)
from bench_port.reference.diffusion.sde import SDE, init_sde

__all__ = ["SDE", "init_sde", "dsm_loss", "edm_loss", "ode_sampler", "pc_sampler",
           "edm_sampler", "ode_likelihood"]
