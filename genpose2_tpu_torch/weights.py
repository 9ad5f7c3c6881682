"""The JAX package's variables as the port's state dicts.

Input: ``{'params', 'batch_stats', 'constants'}`` nested dicts of numpy
arrays, as ``GFObjectPose.init`` / ``ScaleNet.init`` of the JAX package make
them (``jax.device_get`` them first). Output: a ``state_dict`` in the
reference torch layout that the port's modules use. This is the exact inverse
of genpose2_tpu/training/torch_ingest.py:convert_posenet_state_dict /
convert_scalenet_state_dict (Dense kernel (in, out) -> Linear weight
(out, in); SharedMLP Dense -> 1x1 conv (out, in, 1, 1); BatchNorm scale/bias
+ mean/var -> weight/bias + running_mean/running_var). ``dinov3_state_dict``
and ``dinov2_state_dict`` are the inverses of genpose2_tpu/models/vit.py:
load_dinov3_state_dict and load_torch_state_dict for the frozen backbone,
which the agent owns apart from GFObjectPose.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from genpose2_tpu_torch.config import ModelConfig, PointNet2Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class StateDict:
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
        self.bn(bn_p, bn_s, f"{key}.bn.bn")

    def bn(self, bn_p: dict, bn_s: dict, key: str) -> None:
        self.sd[f"{key}.weight"] = _t(bn_p["scale"])
        self.sd[f"{key}.bias"] = _t(bn_p["bias"])
        self.sd[f"{key}.running_mean"] = _t(bn_s["mean"])
        self.sd[f"{key}.running_var"] = _t(bn_s["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def conv1x1(self, p: dict, key: str) -> None:
        """Dense -> 1x1 Conv1d (weight (out, in, 1))."""
        self.sd[f"{key}.weight"] = _t(p["kernel"]).t()[:, :, None].contiguous()
        self.sd[f"{key}.bias"] = _t(p["bias"])

    def layernorm(self, p: dict, key: str) -> None:
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])


def _pointnet2_cls(d: StateDict, params, stats, cfg: PointNet2Config, prefix: str,
                   stages=None) -> None:
    """The SA stack (its first ``stages`` stages when given)."""
    for k, npoint in enumerate(cfg.npoints[:stages]):
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


def shared_mlp(d: StateDict, p: dict, s: dict, key: str) -> None:
    """A SharedMLP (Dense_i + BatchNorm_i) -> ``{key}.layer{i}``."""
    for j in range(sum(1 for name in p if name.startswith("Dense_"))):
        d.conv_bn(p[f"Dense_{j}"]["kernel"], p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"],
                  f"{key}.layer{j}")


def _stn(d: StateDict, p: dict, prefix: str) -> None:
    for i, name in enumerate(("conv1", "conv2", "conv3")):
        d.conv1x1(p[f"Dense_{i}"], f"{prefix}{name}")
    for i, name in enumerate(("fc1", "fc2", "fc3")):
        d.linear(p[f"Dense_{i + 3}"], f"{prefix}{name}")


def pointnet_feat(d: StateDict, p: dict, prefix: str) -> None:
    """PointNetFeat: the inverse of torch_ingest._convert_pointnet_feat."""
    _stn(d, p["STNkd_0"], f"{prefix}stn.")
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4")):
        d.conv1x1(p[f"Dense_{i}"], f"{prefix}{name}")
    if "STNkd_1" in p:
        _stn(d, p["STNkd_1"], f"{prefix}fstn.")


def head_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """RotHead / TransHead variables (Dense_0..3) -> the port's head state
    dict (``conv1``..``conv4``)."""
    d = StateDict()
    for i in range(4):
        d.conv1x1(variables["params"][f"Dense_{i}"], f"conv{i + 1}")
    return d.sd


def segmsg_state_dict(variables: dict, cfg: PointNet2Config,
                      fp_layers: int = 4) -> Dict[str, torch.Tensor]:
    """PointNet2SegMSG variables (``fp_layers`` SA and FP stages) -> the
    port's PointNet2SegMSG state dict. The JAX module creates its
    FeaturePropagation modules coarsest first, so FeaturePropagation_j is
    the port's FP_modules[fp_layers - 1 - j]."""
    d = StateDict()
    params, stats = variables["params"], variables.get("batch_stats", {})
    _pointnet2_cls(d, params, stats, cfg, "", stages=fp_layers)
    for j in range(fp_layers):
        name = f"FeaturePropagation_{j}"
        shared_mlp(d, params[name]["SharedMLP_0"], stats[name]["SharedMLP_0"],
                   f"FP_modules.{fp_layers - 1 - j}.mlp")
    j = 0
    while f"SharedMLP_{j}" in params:
        shared_mlp(d, params[f"SharedMLP_{j}"], stats[f"SharedMLP_{j}"], f"cls_fc.{j}")
        j += 1
    d.linear(params["Dense_0"], "cls_out")
    return d.sd


def relative_pe(d: StateDict, p: dict, key: str) -> None:
    """EfficientRelativePositionalEncoding (Dense_0..4 in creation order)."""
    for j, name in enumerate(("distance_encoder.0", "distance_encoder.2",
                              "direction_encoder.0", "direction_encoder.2", "fusion")):
        d.linear(p[f"Dense_{j}"], f"{key}.{name}")


def gated_fusion(d: StateDict, p: dict, s: dict, key: str) -> None:
    """GatedAttentionFusion: Dense_0 + BatchNorm_0 original transform,
    Dense_1/2 channel attention, Conv_0 spatial attention, Dense_3 +
    BatchNorm_1 gate, Dense_4 + BatchNorm_2 output."""
    d.conv1x1(p["Dense_0"], f"{key}.original_transform.0")
    d.bn(p["BatchNorm_0"], s["BatchNorm_0"], f"{key}.original_transform.1")
    d.conv1x1(p["Dense_1"], f"{key}.channel_attention.1")
    d.conv1x1(p["Dense_2"], f"{key}.channel_attention.3")
    # (7, 2, 1) -> (1, 2, 7)
    d.sd[f"{key}.spatial_attention.0.weight"] = _t(p["Conv_0"]["kernel"]).permute(2, 1, 0).contiguous()
    d.conv1x1(p["Dense_3"], f"{key}.gate.0")
    d.bn(p["BatchNorm_1"], s["BatchNorm_1"], f"{key}.gate.1")
    d.conv1x1(p["Dense_4"], f"{key}.output_conv.0")
    d.bn(p["BatchNorm_2"], s["BatchNorm_2"], f"{key}.output_conv.1")


def _pointnet2_fus(d: StateDict, params, stats, cfg: PointNet2Config, prefix: str) -> None:
    """The inverse of torch_ingest._convert_pointnet2_fus."""
    _pointnet2_cls(d, params, stats, cfg, prefix)
    for k, npoint in enumerate(cfg.npoints):
        if npoint is not None:
            relative_pe(d, params[f"EfficientRelativePositionalEncoding_{k}"],
                        f"{prefix}relative_pos_encoders.{k}")
        tb = params[f"TransformerBlockWithRelativePE_{k}"]
        key = f"{prefix}transformer_blocks.{k}"
        for w in ("wq", "wk", "wv", "wo"):
            d.linear(tb["MultiheadAttentionWithRelativePE_0"][w], f"{key}.self_attn.{w}")
        d.linear(tb["Dense_0"], f"{key}.linear1")
        d.linear(tb["Dense_1"], f"{key}.linear2")
        d.layernorm(tb["LayerNorm_0"], f"{key}.norm1")
        d.layernorm(tb["LayerNorm_1"], f"{key}.norm2")
        if k > 0:
            name = f"GatedAttentionFusion_{k - 1}"
            gated_fusion(d, params[name], stats[name], f"{prefix}feature_fusions.{k - 1}")


def img_encoder(d: StateDict, p, key: str) -> None:
    """The inverse of torch_ingest._convert_img_encoder."""
    d.linear(p["Dense_0"], f"{key}.layer_attn.0")
    d.linear(p["Dense_1"], f"{key}.layer_attn.2")
    d.sd[f"{key}.rel_pos_emb.weight"] = _t(p["Embed_0"]["embedding"])
    # (3, 3, in, out) -> (out, in, 3, 3)
    d.sd[f"{key}.edge_guide.0.weight"] = _t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1).contiguous()
    d.sd[f"{key}.edge_guide.0.bias"] = _t(p["Conv_0"]["bias"])
    d.sd[f"{key}.geo_weight"] = _t(p["geo_weight"])
    d.sd[f"{key}.edge_weight"] = _t(p["edge_weight"])


def _pose_head(d: StateDict, params, constants, regression_head: str, prefix: str) -> None:
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


def _decoder_head(d: StateDict, params, regression_head: str, prefix: str) -> None:
    """PoseDecoderNet: its noise embedding's Dense_0 as the score net's t
    encoder Linear, MLP_0 the pose encoder, the unnamed head MLPs in creation
    order. No reference ``.pth`` of a decoder is in the repository, so these
    names mirror the score net's and are checked against nothing else."""
    d.linear(params["Dense_0"], f"{prefix}t_encoder.1")
    d.mlp(params["MLP_0"], f"{prefix}pose_encoder")
    heads = {"RT": ("fusion_tail",),
             "Rx_Ry_and_T": ("fusion_tail_rot_x", "fusion_tail_rot_y", "fusion_tail_trans")}
    for i, torch_name in enumerate(heads[regression_head]):
        d.mlp(params[f"MLP_{i + 1}"], f"{prefix}{torch_name}")


def posenet_state_dict(variables: dict, cfg: ModelConfig,
                       use_decoder: bool = False) -> Dict[str, torch.Tensor]:
    """GFObjectPose (score or energy, every point encoder and dino mode the
    port takes, see models/posenet.py) variables -> the port's GFObjectPose
    state dict. ``img_encoder.*`` comes along where the tree holds it
    (dino='pointwise'; a global model's tree has none). ``use_decoder``: the
    score agent's EDM decoder (sde mode 'edm') in place of the score net,
    see ``_decoder_head``."""
    d = StateDict()
    params, stats = variables["params"], variables.get("batch_stats", {})
    if cfg.pts_encoder == "pointnet":
        pointnet_feat(d, params["pts_encoder"], "pts_encoder.")
    elif cfg.pts_encoder == "pointnet_and_pointnet2":
        pointnet_feat(d, params["pts_pointnet"], "pts_pointnet_encoder.")
        _pointnet2_cls(d, params["pts_pointnet2"], stats["pts_pointnet2"], cfg.pointnet2,
                       "pts_pointnet2_encoder.")
        d.linear(params["fusion_layer"], "fusion_layer")
    else:
        encoder = _pointnet2_fus if cfg.dino == "pointwise" else _pointnet2_cls
        encoder(d, params["pts_encoder"], stats["pts_encoder"], cfg.pointnet2, "pts_encoder.")
    if "img_encoder" in params:
        img_encoder(d, params["img_encoder"], "img_encoder")
    if use_decoder:
        _decoder_head(d, params["pose_net"], cfg.regression_head, "pose_score_net.")
    else:
        _pose_head(d, params["pose_net"], variables["constants"]["pose_net"],
                   cfg.regression_head, "pose_score_net.")
    return d.sd


def dinov3_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """DinoV3ViT variables ({'params', 'constants'}) -> the DINOv3 torch state
    dict that models/vit.py:DinoV3ViT loads; the inverse of
    genpose2_tpu/models/vit.py:load_dinov3_state_dict (SwiGLU as separate
    w1/w2/w3, ``ls*.gamma``, ``rope_embed.periods``)."""
    p = variables["params"]
    d = StateDict()
    d.sd["cls_token"] = _t(p["cls_token"])
    d.sd["storage_tokens"] = _t(p["storage_tokens"])
    d.sd["rope_embed.periods"] = _t(variables["constants"]["rope_periods"])
    for blk, key in _vit_common(d, p):
        d.linear(blk["attn"]["qkv"], f"{key}.attn.qkv")
        d.linear(blk["attn"]["proj"], f"{key}.attn.proj")
        for w in ("w1", "w2", "w3"):
            d.linear(blk[f"mlp_{w}"], f"{key}.mlp.{w}")
    return d.sd


def _vit_common(d: StateDict, p: dict):
    """The entries both ViTs share (patch embedding, final norm, each block's
    norms and layer scales); yields (block params, state-dict prefix)."""
    # (p, p, 3, dim) -> (dim, 3, p, p)
    d.sd["patch_embed.proj.weight"] = _t(p["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous()
    d.sd["patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    d.layernorm(p["norm"], "norm")
    depth = sum(1 for name in p if name.startswith("block_"))
    for i in range(depth):
        blk, key = p[f"block_{i}"], f"blocks.{i}"
        d.layernorm(blk["norm1"], f"{key}.norm1")
        d.layernorm(blk["norm2"], f"{key}.norm2")
        d.sd[f"{key}.ls1.gamma"] = _t(blk["ls1"])
        d.sd[f"{key}.ls2.gamma"] = _t(blk["ls2"])
        yield blk, key


def dinov2_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """ViT (DINOv2-style) variables ({'params'}) -> the DINOv2 torch state
    dict that models/vit.py:ViT loads; the inverse of
    genpose2_tpu/models/vit.py:load_torch_state_dict (flax attention's
    query/key/value kernels (dim, H, hd) stacked into ``attn.qkv``, ``out``
    (H, hd, dim) into ``attn.proj``)."""
    p = variables["params"]
    d = StateDict()
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in p:
            d.sd[name] = _t(p[name])
    for blk, key in _vit_common(d, p):
        attn = blk["attn"]
        dim = attn["out"]["bias"].shape[0]
        d.sd[f"{key}.attn.qkv.weight"] = torch.cat(
            [_t(attn[n]["kernel"]).reshape(dim, -1).t() for n in ("query", "key", "value")])
        d.sd[f"{key}.attn.qkv.bias"] = torch.cat(
            [_t(attn[n]["bias"]).reshape(-1) for n in ("query", "key", "value")])
        proj = _t(attn["out"]["kernel"]).reshape(-1, dim)  # (H, hd, dim) -> (in, out)
        d.sd[f"{key}.attn.proj.weight"] = proj.t().contiguous()
        d.sd[f"{key}.attn.proj.bias"] = _t(attn["out"]["bias"])
        d.linear(blk["mlp_fc1"], f"{key}.mlp.fc1")
        d.linear(blk["mlp_fc2"], f"{key}.mlp.fc2")
    return d.sd


def scalenet_state_dict(variables: dict) -> Dict[str, torch.Tensor]:
    """ScaleNet variables -> the port's ScaleNet state dict."""
    d = StateDict()
    d.mlp(variables["params"]["MLP_0"], "axes_encoder")
    d.mlp(variables["params"]["MLP_1"], "fusion_tail_length")
    return d.sd
