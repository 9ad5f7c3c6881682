"""The ViT's switch routes of the port against the JAX package's, on the CPU:
``fast_layernorm``, ``vit_attention`` (an unpadded token axis) and
``vit_attention_tm`` with RoPE inside the kernel, each op's plain version
against the JAX function (Pallas in interpret mode); then ``DinoV3ViT`` at
tiny_flagship_config's backbone (depth 2, dim 48, 64-px crops) with the two
switches ``_INKERNEL_ROPE`` and ``_DEFER_TAIL`` set alike in both packages,
and one ``DinoV3Block`` on an unpadded 261-token axis.

The same numpy inputs, made from a seed, go to both packages. A JAX module or
provider is built after each switch is set, so that no trace made under the
other setting is reused. Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genpose2_tpu.models.vit as jax_vit
import genpose2_tpu_torch.models.vit as port_vit
from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.models.provider import ImageFeatureProvider as JaxProvider
from genpose2_tpu.ops.layernorm import fast_layernorm as jax_fast_layernorm
from genpose2_tpu.ops.vit_attention import vit_attention as jax_vit_attention
from genpose2_tpu.ops.vit_attention import vit_attention_tm as jax_vit_attention_tm
from genpose2_tpu_torch.config import tiny_flagship_config
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.models.vit import rope_tables
from genpose2_tpu_torch.ops.layernorm import fast_layernorm
from genpose2_tpu_torch.ops.vit_attention import vit_attention, vit_attention_tm
from genpose2_tpu_torch.weights import dinov3_state_dict

B, S, H, C = 2, 64, 6, 48
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWITCHES = {"off": (False, False), "rope": (True, False), "tail": (False, True),
            "both": (True, True)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _randomize(variables, seed, scale=0.1):
    """numpy copy of a variable tree with every leaf moved by N(0, scale)
    (RoPE periods kept)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "rope_periods":
            return x
        return (x + rng.normal(0.0, scale, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def _model_cfg(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def _switch(monkeypatch, rope: bool, tail: bool):
    for module in (jax_vit, port_vit):
        monkeypatch.setattr(module, "_INKERNEL_ROPE", rope)
        monkeypatch.setattr(module, "_DEFER_TAIL", tail)


def _qkv(rng, n, dtype):
    jdt, pdt = DTYPES[dtype]
    arrs = [rng.normal(size=(B, n, C)).astype(np.float32) for _ in range(3)]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [_t(a).to(pdt) for a in arrs]


# ------------------------------------------------------------------- the ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 37, C)) * 2.0 + 0.5).astype(np.float32)
    s, b = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    jdt, pdt = DTYPES[dtype]
    want = jax_fast_layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(s), jnp.asarray(b))
    got = fast_layernorm(_t(x).to(pdt), _t(s), _t(b))
    assert got.dtype == pdt and got.shape == x.shape
    # float32: the JAX package's LayerNorm bound (tests/test_ops.py:599);
    # bf16: one rounding of the same float32 value
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,n_valid", [(261, 261), (40, 33), (5, 5)])
def test_unpadded_vit_attention_matches_jax(dtype, n, n_valid):
    jq, pq = _qkv(np.random.default_rng(2), n, dtype)
    want = jax_vit_attention(*jq, H, n_valid=n_valid)
    got = vit_attention(*pq, H, n_valid=n_valid)
    assert got.dtype == torch.float32 and got.shape == (B, n, C)
    # the JAX package's bounds for its kernels (tests/test_ops.py:546, 566)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,n_pad", [("float32", 24), ("bfloat16", 32)])
def test_rope_vit_attention_matches_jax(dtype, n_pad):
    n_valid, hd = 21, C // H
    jq, pq = _qkv(np.random.default_rng(3), n_pad, dtype)
    # the flagship layout of the tables: identity rows for the 5 prefix tokens
    # and the pad rows, the 4x4 patch grid's angles in between
    periods = torch.tensor(100.0) ** (torch.arange(hd // 4, dtype=torch.float32) / (hd // 4))
    sin, cos = rope_tables(periods, 4, 4)
    sin = torch.cat([torch.zeros(5, hd), sin, torch.zeros(n_pad - n_valid, hd)])
    cos = torch.cat([torch.ones(5, hd), cos, torch.ones(n_pad - n_valid, hd)])
    want = jax_vit_attention_tm(*jq, H, n_valid=n_valid, sin=jnp.asarray(sin.numpy()),
                                cos=jnp.asarray(cos.numpy()))
    got = vit_attention_tm(*pq, H, n_valid=n_valid, sin=sin, cos=cos)
    assert got.dtype == torch.float32
    # as the rope=False kernel, on the real rows: the rotation is float32 on
    # both sides and rounds to the input dtype once
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy()[:, :n_valid], np.asarray(want)[:, :n_valid],
                               rtol=tol, atol=tol)
    # the tables do rotate: without them the result moves
    plain = vit_attention_tm(*pq, H, n_valid=n_valid)
    assert float((plain - got)[:, :n_valid].abs().max()) > 10 * tol


# ---------------------------------------------------------------- the backbone
@pytest.fixture(scope="module")
def backbone():
    """Random DINOv3 variables at tiny_flagship_config's backbone and one batch
    of N(0, 1) crops."""
    cfg = jax_flagship_config().model
    pvars = _randomize(JaxProvider(cfg).init(jax.random.PRNGKey(0)), 5)
    rgb = np.random.default_rng(6).normal(size=(B, S, S, 3)).astype(np.float32)
    return pvars, rgb


class _Routes:
    """Counts the ViT's calls into its ops, by route, while wrapping them."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("vit_attention_tm", "vit_attention", "fast_layernorm", "fast_add_layernorm"):
            fn = getattr(port_vit, name)
            monkeypatch.setattr(port_vit, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def run(*a, **k):
            rope = k.get("sin") is not None
            self.calls.append(name + (".rope" if rope else ""))
            return fn(*a, **k)
        return run

    def count(self, name):
        return self.calls.count(name)


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dinov3_switched_taps_and_cls_match_jax(backbone, monkeypatch, switches, dtype):
    pvars, rgb = backbone
    rope, tail = SWITCHES[switches]
    _switch(monkeypatch, rope, tail)
    jcfg = _model_cfg(jax_flagship_config(), backbone_dtype=dtype).model
    pcfg = _model_cfg(tiny_flagship_config(), backbone_dtype=dtype).model
    jprov = JaxProvider(jcfg)  # traced after the switches are set
    want_taps = jprov.patch_features(pvars, jnp.asarray(rgb))
    want_cls = jprov.global_feature(pvars, jnp.asarray(rgb))
    prov = ImageFeatureProvider(pcfg)
    prov.vit.load_state_dict(dinov3_state_dict(pvars))
    routes = _Routes(monkeypatch)
    got_taps = prov.patch_features(_t(rgb))
    got_cls = prov.global_feature(_t(rgb))
    # each of the two forwards, two blocks: the route the switches select
    depth, deferred = 2, tail and dtype == "bfloat16"
    assert routes.count("vit_attention_tm.rope") == (2 * depth if rope else 0)
    assert routes.count("vit_attention_tm") == (0 if rope else 2 * depth)
    assert routes.count("vit_attention") == 0
    assert routes.count("fast_layernorm") == (2 if deferred else 0)
    assert routes.count("fast_add_layernorm") == (
        2 * (2 * depth - 1) if deferred else (2 * depth if dtype == "bfloat16" else 0))
    assert len(got_taps) == len(want_taps) == 2
    assert got_cls.shape == want_cls.shape == (B, 48) and got_cls.dtype == torch.float32
    # as test_dinov3_taps_match_jax: float32, summation order through two
    # blocks and the final norm; bf16, the same bf16 residual stream, where a
    # flipped rounding moves a normalised value by a bf16 step or two
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got_taps, want_taps):
        assert g.shape == w.shape == (B, 16, 48)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=tol, atol=tol)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpadded_block_matches_jax(backbone, monkeypatch, rope, dtype):
    """One block on a 261-token axis (cls + 4 storage + 16 x 16 patches), the
    route of DinoV3Attention for an unpadded axis; with the in-kernel RoPE
    switch on too, which needs a padded axis and so falls back alike."""
    pvars, _ = backbone
    _switch(monkeypatch, rope, False)
    jdt, pdt = DTYPES[dtype]
    N = 261
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    hd = C // H
    sin, cos = rope_tables(torch.tensor(100.0) ** (torch.arange(2, dtype=torch.float32) / 2),
                           16, 16)
    sin = torch.cat([torch.zeros(5, hd), sin]).repeat(1, H)
    cos = torch.cat([torch.ones(5, hd), cos]).repeat(1, H)
    jblock = jax_vit.DinoV3Block(C, H, 4 * C, dtype=None if dtype == "float32" else jdt)
    want, pending = jblock.apply({"params": pvars["params"]["block_0"]},
                                 jnp.asarray(x).astype(jdt), jnp.asarray(sin.numpy()),
                                 jnp.asarray(cos.numpy()), N)
    assert pending is None
    vit = port_vit.DinoV3ViT(16, C, 1, H, 4, 4 * C, dtype=None if dtype == "float32" else pdt)
    sd = dinov3_state_dict(pvars)
    vit.load_state_dict({k: v for k, v in sd.items() if not k.startswith("blocks.1.")})
    routes = _Routes(monkeypatch)
    with torch.no_grad():
        got, pend = vit.blocks[0](_t(x).to(pdt), sin, cos, N, vit.dtype)
    assert pend is None and routes.calls.count("vit_attention") == 1
    assert got.dtype == pdt and got.shape == (B, N, C)
    # float32: summation order through one block; bf16: the residual stream
    # in bf16, a flipped rounding moves a value by a bf16 step of values ~4
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
