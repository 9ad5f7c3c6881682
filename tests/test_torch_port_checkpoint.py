"""Loading a reference ``.pth`` into the port (genpose2_tpu_torch/api.py):
the ``{'model_state_dict': sd, ...}`` wrapper, the entries the port does not
build (the Fus encoder's GroupAll-stage relative PE and the fusions'
``downsample``, ``img_encoder`` in a ``dino='global'`` model), a missing
entry, embedded backbone tensors without a backbone, and the JAX package's
own loader (genpose2_tpu/training/checkpoint.py:load_torch_params_only)
reading the same file.

The state dicts come from randomised JAX variables through
genpose2_tpu_torch/weights.py, as in the other parity tests.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu.training.checkpoint import load_torch_params_only
from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict, scalenet_state_dict

B, N = 2, 128


def randomize(variables, seed, scale=0.1):
    """numpy copy of a variable tree with every leaf randomised (variances
    positive, Fourier weights and RoPE periods kept)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key in ("W", "rope_periods"):
            return x
        return (x + rng.normal(0.0, scale, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    S = cfg.model.img_size
    b = {"pts": rng.uniform(-0.3, 0.3, size=(B, N, 3)).astype(np.float32),
         "zero_mean_gt_pose": np.zeros((B, 9), np.float32),
         "roi_rgb": rng.normal(size=(B, S, S, 3)).astype(np.float32),
         "roi_xs": rng.integers(0, S, (B, N)).astype(np.int32),
         "roi_ys": rng.integers(0, S, (B, N)).astype(np.int32)}
    return b


def _global(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, dino="global"))


@pytest.fixture(scope="module")
def flagship():
    """Randomised JAX score variables at tiny_flagship_config, their JAX
    agent and state, and the reference state dict with the backbone under
    ``dino.``."""
    jcfg, pcfg = jax_flagship_config(), tiny_flagship_config()
    jbatch = jax.tree.map(jnp.asarray, _batch(pcfg))
    agent = JaxPoseAgent(jcfg, "score", steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(1), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, 1)
    consts = {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}
    sd = posenet_state_dict({"params": vs["params"], "batch_stats": vs["batch_stats"],
                             "constants": consts}, pcfg.model)
    sd.update({f"dino.{k}": v for k, v in dinov3_state_dict(vs["constants"][PROVIDER_KEY]).items()})
    return {"jcfg": jcfg, "pcfg": pcfg, "agent": agent, "state": state, "sd": sd}


def _dead_entries(sd, cfg):
    """What a reference Fus checkpoint holds beyond the port's modules: the
    GroupAll stage's relative PE (shaped like stage 0's) and a ``downsample``
    conv + BatchNorm in every gated fusion (shaped like its
    ``original_transform``)."""
    g = torch.Generator().manual_seed(5)
    k = list(cfg.model.pointnet2.npoints).index(None)
    extra = {}
    for key, v in sd.items():
        if key.startswith("pts_encoder.relative_pos_encoders.0."):
            extra[key.replace(".0.", f".{k}.", 1)] = torch.randn(v.shape, generator=g)
        if ".original_transform." in key and key.startswith("pts_encoder.feature_fusions."):
            new = key.replace(".original_transform.", ".downsample.")
            extra[new] = v.clone() if v.dtype != torch.float32 else torch.randn(v.shape,
                                                                              generator=g)
    return extra


def _weights_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.values(), b.values())) and a.keys() == b.keys()


def test_wrapped_reference_file_loads_like_the_bare_dict(flagship, tmp_path):
    cfg, sd = flagship["pcfg"], flagship["sd"]
    extra = _dead_entries(sd, cfg)
    assert extra and any(".downsample." in k for k in extra)
    path = str(tmp_path / "score.pth")
    torch.save({"model_state_dict": {**sd, **extra}, "epoch": 0}, path)
    with pytest.warns(UserWarning) as record:
        from_file = GenPose2(cfg, score=path, device="cpu")
    message = " ".join(str(w.message) for w in record)
    # one warning names every dropped entry
    assert all(k in message for k in extra)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the bare dict drops nothing
        from_dict = GenPose2(cfg, score=sd, device="cpu")
    a, b = from_file.score_agent, from_dict.score_agent
    assert _weights_equal(a.model.state_dict(), b.model.state_dict())
    assert _weights_equal(a.provider.vit.state_dict(), b.provider.vit.state_dict())


def test_missing_entry_raises(flagship):
    sd = dict(flagship["sd"])
    gone = next(k for k in sd if k.startswith("pose_score_net."))
    del sd[gone]
    with pytest.raises(KeyError, match=gone):
        GenPose2(flagship["pcfg"], score={"model_state_dict": sd}, device="cpu")


def test_global_model_drops_img_encoder(flagship):
    """A reference dino='global' checkpoint may carry img_encoder.* (the JAX
    posenet declares it whenever dino != 'none'); the port's global model has
    none and drops them by name."""
    pcfg = _global(flagship["pcfg"])
    ref = GenPose2(pcfg, device="cpu").score_agent
    sd = dict(ref.model.state_dict())
    img = {k: v for k, v in flagship["sd"].items() if k.startswith("img_encoder.")}
    assert img and not any(k.startswith("img_encoder.") for k in sd)
    with pytest.warns(UserWarning, match="img_encoder"):
        eng = GenPose2(pcfg, score={**sd, **img}, device="cpu")
    assert _weights_equal(eng.score_agent.model.state_dict(), sd)


def test_backbone_tensors_without_a_backbone_warn():
    cfg = tiny_test_config()  # dino='none': no backbone
    sd = dict(GenPose2(cfg, device="cpu").score_agent.model.state_dict())
    with pytest.warns(UserWarning, match="2 DINO backbone tensors"):
        GenPose2(cfg, score={**sd, "dino.a": torch.zeros(1), "dino.b": torch.zeros(1)},
                 device="cpu")


def test_wrapped_scale_file_loads(tmp_path):
    jcfg, pcfg = jax_flagship_config(), tiny_flagship_config()
    pts_dim = sum(m[-1] for m in pcfg.model.pointnet2.mlps[-1])  # as GenPose2 sizes it
    st = JaxScaleAgent(jcfg).init_state(jax.random.PRNGKey(3), pts_dim=pts_dim)
    sd = scalenet_state_dict(randomize({"params": st.params}, 3))
    path = str(tmp_path / "scale.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    eng = GenPose2(pcfg, scale=path, device="cpu")
    assert _weights_equal(eng.scale_agent.model.state_dict(), sd)


def test_jax_loader_reads_the_same_file(flagship, tmp_path):
    """The JAX package's reference loader and the port read one wrapped file
    (with the dead entries) into the same features."""
    cfg, sd = flagship["pcfg"], flagship["sd"]
    path = str(tmp_path / "score.pth")
    torch.save({"model_state_dict": {**sd, **_dead_entries(sd, cfg)}, "epoch": 0}, path)
    agent = flagship["agent"]
    state = load_torch_params_only(path, flagship["state"], cfg=flagship["jcfg"],
                                   provider=agent.provider)
    batch = _batch(cfg, 1)
    jbatch = agent.with_image_features(state, jax.tree.map(jnp.asarray, batch))
    want = np.asarray(agent.extract_features(state, jbatch)[0])
    with pytest.warns(UserWarning):
        port = GenPose2(cfg, score=path, device="cpu").score_agent
    got = port.extract_features({k: torch.from_numpy(v) for k, v in batch.items()})[0].numpy()
    # float32 on both sides, the same weights and inputs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
