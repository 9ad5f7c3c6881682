"""Checkpoints of a train state as torch files (port of
genpose2_tpu/training/checkpoint.py, torch files in place of orbax).

A checkpoint holds the whole ``TrainState`` by the reference state-dict
names: ``step``, ``params``, ``buffers`` (BatchNorm running statistics),
``opt_state`` (the update count and Adam's moments or SGD's trace, by
parameter name), ``ema_params`` and ``ema_updates``; and, given the agent, the
model's other state-dict entries under ``constants`` (the fixed random
Fourier projections, ``num_batches_tracked``) and its frozen backbone's
weights under ``dino`` (the JAX package keeps both in the state's
constants). The EMA is saved apart from the weights, so a resume is exact.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from genpose2_tpu_torch.training.agent import TrainState

_TORCH_SUFFIXES = (".pth", ".pt", ".pth.tar", ".pt.tar")


def _cpu(d: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in d.items()}


def _backbone(agent):
    provider = getattr(agent, "provider", None)
    return None if provider is None else provider.vit


def _constants(agent, state: TrainState) -> dict:
    """The model's state-dict entries that the train state does not hold."""
    return {k: v for k, v in agent.model.state_dict().items()
            if k not in state.params and k not in state.buffers}


def save_checkpoint(ckpt_dir: str, state: TrainState, name: Optional[str] = None,
                    agent=None) -> str:
    """Write ``<ckpt_dir>/<name or step_N>`` atomically (a temporary file, then
    a rename); ``agent``'s constants and backbone go with it. Returns the
    path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name or f"step_{int(state.step)}")
    names = list(state.params)
    opt = {"count": int(state.opt_state["count"])}
    for k, v in state.opt_state.items():
        if k != "count":
            opt[k] = _cpu(dict(zip(names, v)))
    blob = {"step": int(state.step), "params": _cpu(state.params),
            "buffers": _cpu(state.buffers), "opt_state": opt,
            "ema_params": _cpu(state.ema_params), "ema_updates": float(state.ema_updates)}
    if agent is not None:
        blob["constants"] = _cpu(_constants(agent, state))
    vit = _backbone(agent)
    if vit is not None:
        blob["dino"] = _cpu(vit.state_dict())
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def _copy_into(dst: dict, src: dict, what: str) -> None:
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise KeyError(f"checkpoint {what}: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, t in dst.items():
        t.copy_(src[k])


@torch.no_grad()
def _load_agent_parts(blob: dict, agent, state: TrainState) -> None:
    """The constants and the backbone of a checkpoint into ``agent``."""
    if agent is None:
        return
    if "constants" in blob:
        _copy_into(_constants(agent, state), blob["constants"], "constants")
    vit = _backbone(agent)
    if vit is not None and "dino" in blob:
        vit.load_state_dict(blob["dino"])


def load_checkpoint(path: str, target: TrainState, agent=None) -> TrainState:
    """Restore a checkpoint into ``target`` (a state of the same agent) in
    place, the optimizer and the EMA included, and ``agent``'s constants
    and backbone."""
    blob = _read(path)
    _copy_into(target.params, blob["params"], "params")
    _copy_into(target.buffers, blob["buffers"], "buffers")
    _copy_into(target.ema_params, blob["ema_params"], "ema_params")
    names = list(target.params)
    for k, v in target.opt_state.items():
        if k == "count":
            continue
        with torch.no_grad():
            for name, t in zip(names, v):
                t.copy_(blob["opt_state"][k][name])
    target.opt_state["count"] = blob["opt_state"]["count"]
    target.step = blob["step"]
    target.ema_updates = blob["ema_updates"]
    _load_agent_parts(blob, agent, target)
    return target


def is_torch_checkpoint(path: str) -> bool:
    """A reference torch checkpoint (``.pth``/``.pt``), not one of ours."""
    return path.endswith(_TORCH_SUFFIXES)


@torch.no_grad()
def load_params_only(path: str, target: TrainState, use_ema_as_params: bool = False,
                     agent=None) -> TrainState:
    """The weights of a checkpoint into ``target``, keeping its step and
    optimizer: params (the checkpoint's EMA weights with
    ``use_ema_as_params``), ema_params, BatchNorm statistics and ``agent``'s
    constants and backbone. A reference ``.pth`` (one copy of the weights:
    the reference folds the EMA in when it saves) goes through ``api.py``'s
    loaders, its ``dino.*`` entries into the backbone, and gives params and
    ema_params alike; it needs ``agent``."""
    if is_torch_checkpoint(path):
        from genpose2_tpu_torch.api import _state_dict, load_pose_weights, load_scale_weights

        if agent is None:
            raise ValueError(f"{path}: a reference checkpoint loads through its agent; pass "
                             "agent=")
        sd = _state_dict(path)
        sd = sd.get("model_state_dict", sd)
        if any(k.startswith("fusion_tail_length.") for k in sd):
            load_scale_weights(agent, sd)
        else:
            load_pose_weights(agent, sd)
        for k, p in target.params.items():
            target.ema_params[k].copy_(p)
        return target
    blob = _read(path)
    _copy_into(target.params, blob["ema_params" if use_ema_as_params else "params"], "params")
    _copy_into(target.ema_params, blob["ema_params"], "ema_params")
    _copy_into(target.buffers, blob["buffers"], "buffers")
    _load_agent_parts(blob, agent, target)
    return target
