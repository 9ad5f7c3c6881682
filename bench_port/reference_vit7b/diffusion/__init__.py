# Frozen copy of genpose2_tpu_torch/diffusion/__init__.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
from bench_port.reference_vit7b.diffusion.losses import dsm_loss, edm_loss
from bench_port.reference_vit7b.diffusion.samplers import (edm_sampler, ode_likelihood, ode_sampler,
                                                   pc_sampler)
from bench_port.reference_vit7b.diffusion.sde import SDE, init_sde

__all__ = ["SDE", "init_sde", "dsm_loss", "edm_loss", "ode_sampler", "pc_sampler",
           "edm_sampler", "ode_likelihood"]
