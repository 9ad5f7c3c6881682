"""Stand-in for the port's utils/profiling.py: the reference records no
spans and keeps no counters; what the copy calls, without effect."""

import torch


class span:
    """A context manager and a decorator that do nothing."""

    def __init__(self, name: str, unit: bool = False):
        self.name = name

    def __call__(self, fn):
        return fn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def to_host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu()


def note_backbone_weights(nbytes: int) -> None:
    pass
