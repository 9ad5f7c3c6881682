from genpose2_tpu_torch.diffusion.losses import dsm_loss, edm_loss
from genpose2_tpu_torch.diffusion.samplers import (edm_sampler, ode_likelihood, ode_sampler,
                                                   pc_sampler)
from genpose2_tpu_torch.diffusion.sde import SDE, init_sde

__all__ = ["SDE", "init_sde", "dsm_loss", "edm_loss", "ode_sampler", "pc_sampler",
           "edm_sampler", "ode_likelihood"]
