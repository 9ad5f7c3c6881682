from genpose2_tpu_torch.diffusion.losses import dsm_loss
from genpose2_tpu_torch.diffusion.samplers import (edm_sampler, ode_likelihood, ode_sampler,
                                                   pc_sampler)
from genpose2_tpu_torch.diffusion.sde import SDE, init_sde

# the JAX package's names but edm_loss, which waits with the decoder's
# training (ROADMAP.md queue 1, the rest of training)
__all__ = ["SDE", "init_sde", "dsm_loss", "ode_sampler", "pc_sampler", "edm_sampler",
           "ode_likelihood"]
