from genpose2_tpu_torch.diffusion.samplers import ode_sampler
from genpose2_tpu_torch.diffusion.sde import SDE, init_sde

__all__ = ["SDE", "init_sde", "ode_sampler"]
