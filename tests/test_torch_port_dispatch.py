"""Where the port picks a kernel or its plain version, on the CPU.

``ops/_cuda.py:launches`` is the one predicate: true for a tensor off the
CPU outside ``plain_versions()``. Each op wrapper asks it of one of its
tensors (its points, or q) before anything else; no function of the port
outside ``ops/`` takes a ``plain`` argument. ``meta`` tensors stand in for
the card's: they are off the CPU and need no device.
"""

import importlib
import inspect
import pkgutil

import pytest
import torch

import genpose2_tpu_torch
from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.layernorm import fast_layernorm


def _tensor(device):
    return torch.zeros(2, 3, device=device)


@pytest.mark.parametrize("device,launches", [("cpu", False), ("meta", True)])
def test_launches_outside_the_scope(device, launches):
    assert _cuda.launches(_tensor(device)) is launches


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_versions_on_any_device(device):
    t = _tensor(device)
    with _cuda.plain_versions():
        assert not _cuda.launches(t)
    assert _cuda.launches(t) is (device != "cpu")


def test_plain_versions_nest_and_restore():
    t = _tensor("meta")
    with _cuda.plain_versions():
        with _cuda.plain_versions():
            assert not _cuda.launches(t)
        assert not _cuda.launches(t)  # the inner block's exit keeps the outer one
    assert _cuda.launches(t)
    with pytest.raises(KeyError):
        with _cuda.plain_versions():
            raise KeyError("inside")
    assert _cuda.launches(t)


def test_an_op_inside_the_scope_runs_its_plain_version_off_the_cpu():
    x = torch.empty(4, 7, 48, device="meta")
    scale, bias = torch.empty(48, device="meta"), torch.empty(48, device="meta")
    with _cuda.plain_versions():
        y = fast_layernorm(x, scale, bias)
    assert y.device.type == "meta" and y.shape == x.shape


# (module, op wrapper, the position of the tensor it asks about)
DISPATCHERS = [
    ("fps", "furthest_point_sample", 0),
    ("ball_query", "ball_query", 0),
    ("ball_query", "ball_count", 0),
    ("fused_sa", "fused_sa_stage", 0),
    ("fused_sa", "fused_sa_scale", 0),
    ("fused_sa", "fused_group_mlp_pool", 0),
    ("ode_rk4", "fused_rk4_integrate", 0),
    ("layernorm", "fast_residual_layernorm", 0),
    ("layernorm", "fast_add_layernorm", 0),
    ("layernorm", "fast_layernorm", 0),
    ("relpe_attention", "relpe_attention", 1),  # q
    ("vit_attention", "vit_attention_tm", 0),
    ("vit_attention", "vit_attention", 0),
]


class _Asked(Exception):
    pass


@pytest.mark.parametrize("module,name,position", DISPATCHERS)
def test_each_op_wrapper_asks_launches_first(monkeypatch, module, name, position):
    fn = getattr(importlib.import_module(f"genpose2_tpu_torch.ops.{module}"), name)
    t = torch.zeros(1, 4, 3)
    asked = []

    def launches(t):
        asked.append(t)
        raise _Asked

    monkeypatch.setattr(_cuda, "launches", launches)
    args = [None] * len(inspect.signature(fn).parameters)
    args[position] = t
    with pytest.raises(_Asked):
        fn(*args)
    assert len(asked) == 1 and asked[0] is t


def _functions(module):
    """Every function and method defined in ``module``, with its name."""
    for name, obj in vars(module).items():
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if inspect.isfunction(obj):
            yield name, obj
        elif inspect.isclass(obj):
            for attr, member in vars(obj).items():
                member = getattr(member, "__func__", member)  # static and class methods
                if inspect.isfunction(member):
                    yield f"{name}.{attr}", member


def test_no_function_outside_ops_takes_plain():
    found, seen = [], 0
    for info in pkgutil.walk_packages(genpose2_tpu_torch.__path__, "genpose2_tpu_torch."):
        if info.name.startswith("genpose2_tpu_torch.ops"):
            continue
        module = importlib.import_module(info.name)
        for name, fn in _functions(module):
            seen += 1
            if "plain" in inspect.signature(fn).parameters:
                found.append(f"{info.name}:{name}")
    assert seen > 300  # the walk reached the package's functions
    assert not found, found
