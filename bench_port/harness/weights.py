"""Random weights from the seed, made on the modules' device.

Every floating parameter moves by N(0, 0.02) from its initial value (output
layers start at zero, so an unmoved model says nothing), BatchNorm running
means are drawn from N(0, 0.05^2) and running variances from U[0.5, 1.5).
The draws come from one ``torch.Generator`` on the device, in one large call
per kind, not leaf by leaf. Initial values come from the modules'
constructors under ``torch.manual_seed(seed)``, so the port and the frozen
reference, whose modules are copies of the port's, build the same weights
from the seed when they build their modules in the same order."""

from __future__ import annotations

from typing import Sequence

import torch


def _leaves(modules: Sequence[torch.nn.Module]):
    params, means, variances = [], [], []
    for module in modules:
        params += [p for p in module.parameters() if p.is_floating_point()]
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                means.append(b)
            elif name.endswith("running_var"):
                variances.append(b)
    return params, means, variances


@torch.no_grad()
def randomize(modules: Sequence[torch.nn.Module], seed: int, device) -> int:
    """Move every module's weights as the module docstring says; returns the
    number of values drawn."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = 0
    for leaves, draw in zip(_leaves(modules), (
            lambda n: torch.randn(n, generator=gen, device=device) * 0.02,
            lambda n: torch.randn(n, generator=gen, device=device) * 0.05,
            lambda n: torch.rand(n, generator=gen, device=device) + 0.5)):
        n = sum(t.numel() for t in leaves)
        if n == 0:
            continue
        values = draw(n)
        total += n
        at = 0
        is_param = isinstance(leaves[0], torch.nn.Parameter)
        for t in leaves:
            v = values[at:at + t.numel()].view(t.shape).to(t.dtype)
            if is_param:
                t.add_(v)
            else:
                t.copy_(v)
            at += t.numel()
    return total
