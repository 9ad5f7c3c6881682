"""Stand-in for the port's parallel/mesh.py: the no-mesh bodies of the
helpers the models call; the reference runs in one process."""

import torch


def active_mesh():
    return None


def batch_rand(shape, generator=None, device=None, batch_axis: int = 0, **kw) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device, **kw)


def batch_randn(shape, generator=None, device=None, batch_axis: int = 0, **kw) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, **kw)
