"""The JAX package's variables as the port's state dicts.

Input: ``{'params', 'batch_stats', 'constants'}`` nested dicts of numpy
arrays, as ``GFObjectPose.init`` / ``ScaleNet.init`` of the JAX package make
them (``jax.device_get`` them first). Output: a ``state_dict`` in the
reference torch layout that the port's modules use. This is the exact inverse
of genpose2_tpu/training/torch_ingest.py:convert_posenet_state_dict /
convert_scalenet_state_dict (Dense kernel (in, out) -> Linear weight
(out, in); SharedMLP Dense -> 1x1 conv (out, in, 1, 1); BatchNorm scale/bias
+ mean/var -> weight/bias + running_mean/running_var).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from genpose2_tpu_torch.config import ModelConfig, PointNet2Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _StateDict:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def linear(self, p: dict, key: str) -> None:
        self.sd[f"{key}.weight"] = _t(p["kernel"]).t().contiguous()
        self.sd[f"{key}.bias"] = _t(p["bias"])

    def mlp(self, p: dict, key: str) -> None:
        for i in range(len(p)):
            self.linear(p[f"Dense_{i}"], f"{key}.{2 * i}")

    def conv_bn(self, kernel, bn_p: dict, bn_s: dict, key: str) -> None:
        w = _t(kernel).t()
        self.sd[f"{key}.conv.weight"] = w.reshape(w.shape[0], w.shape[1], 1, 1).contiguous()
        self.sd[f"{key}.bn.bn.weight"] = _t(bn_p["scale"])
        self.sd[f"{key}.bn.bn.bias"] = _t(bn_p["bias"])
        self.sd[f"{key}.bn.bn.running_mean"] = _t(bn_s["mean"])
        self.sd[f"{key}.bn.bn.running_var"] = _t(bn_s["var"])
        self.sd[f"{key}.bn.bn.num_batches_tracked"] = torch.tensor(0)


def _pointnet2_cls(d: _StateDict, params, stats, cfg: PointNet2Config, prefix: str) -> None:
    for k, npoint in enumerate(cfg.npoints):
        p, s = params[f"SetAbstractionMSG_{k}"], stats[f"SetAbstractionMSG_{k}"]
        for sc in range(len(cfg.mlps[k])):
            key = f"{prefix}SA_modules.{k}.mlps.{sc}"
            mp, ms = p[f"SharedMLP_{sc}"], s[f"SharedMLP_{sc}"]
            first = 0
            if npoint is not None:  # grouped: layer 0 is the projection
                d.conv_bn(p[f"proj_kernel_{sc}"], p[f"BatchNorm_{sc}"], s[f"BatchNorm_{sc}"],
                          f"{key}.layer0")
                first = 1
            n_dense = sum(1 for name in mp if name.startswith("Dense_"))
            for j in range(n_dense):
                d.conv_bn(mp[f"Dense_{j}"]["kernel"], mp[f"BatchNorm_{j}"], ms[f"BatchNorm_{j}"],
                          f"{key}.layer{j + first}")


def _pose_head(d: _StateDict, params, constants, regression_head: str, prefix: str) -> None:
    d.sd[f"{prefix}t_encoder.0.W"] = _t(constants["GaussianFourierProjection_0"]["W"])
    d.linear(params["Dense_0"], f"{prefix}t_encoder.1")
    d.mlp(params["MLP_0"], f"{prefix}pose_encoder")
    names = {
        "RT": {"MLP_1": "fusion_tail"},
        "R_and_T": {"MLP_1": "fusion_tail_rot", "MLP_2": "fusion_tail_trans"},
        "Rx_Ry_and_T": {n: n for n in ("fusion_tail_rot_x", "fusion_tail_rot_y",
                                       "fusion_tail_trans")},
    }[regression_head]
    for jax_name, torch_name in names.items():
        d.mlp(params[jax_name], f"{prefix}{torch_name}")


def posenet_state_dict(variables: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """GFObjectPose (score or energy, dino='none', pointnet2) variables -> the
    port's GFObjectPose state dict."""
    if cfg.dino != "none" or cfg.pts_encoder != "pointnet2":
        raise NotImplementedError("only dino='none' with pts_encoder='pointnet2' is ported")
    d = _StateDict()
    params, stats = variables["params"], variables.get("batch_stats", {})
    _pointnet2_cls(d, params["pts_encoder"], stats["pts_encoder"], cfg.pointnet2, "pts_encoder.")
    _pose_head(d, params["pose_net"], variables["constants"]["pose_net"], cfg.regression_head,
               "pose_score_net.")
    return d.sd


def scalenet_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """ScaleNet variables -> the port's ScaleNet state dict."""
    d = _StateDict()
    d.mlp(variables["params"]["MLP_0"], "axes_encoder")
    d.mlp(variables["params"]["MLP_1"], "fusion_tail_length")
    return d.sd
