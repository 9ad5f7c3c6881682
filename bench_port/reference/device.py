# Frozen copy of genpose2_tpu_torch/device.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without an explicit device they raise: a silent fall back to the
CPU would hide that the kernels never ran.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> ``cuda`` (raises when no card is present); else ``device``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")
