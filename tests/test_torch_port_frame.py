"""The port's frame entry point and dense-cloud route against the JAX package's.

- Crops: the port's OpenCV-free ``data/roi.py`` against the JAX package's,
  which calls cv2.
- Front end: ``frame_to_object_batch`` -> ``process_batch`` on a synthetic
  frame, on the native and on the numpy branch.
- Dense route: ``stage_route`` against the JAX package's choice, the plain
  ``fused_sa_scale`` / ``fused_group_mlp_pool`` against the JAX kernels (Pallas
  in interpret mode, as the JAX package's tests run them on the CPU), and a
  2,048-point encoder forward whose stage 0 takes the per-scale route.
- API: ``GenPose2`` against ``GenPose2TPU`` at tiny_flagship_config, detection
  then two tracking calls, with the JAX side's prior and energy times
  rebuilt from its key.

Inputs come from numpy seeds; tolerances are stated at each assert.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genpose2_tpu.ops.fused_sa as jax_fused_sa
from genpose2_tpu.api import GenPose2TPU
from genpose2_tpu.config import LIGHTER_POINTNET2 as JAX_LIGHTER
from genpose2_tpu.config import PointNet2Config as JaxPointNet2Config
from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.data import roi as jax_roi
from genpose2_tpu.data.infer_dataset import frame_to_object_batch as jax_frame_to_object_batch
from genpose2_tpu.data.loader import process_batch as jax_process_batch
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.models.fast_encoder import fast_cls_forward as jax_fast_cls_forward
from genpose2_tpu.models.posenet import GFObjectPose as JaxGFObjectPose
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.ops.ball_query_pallas import ball_count as jax_ball_count
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import LIGHTER_POINTNET2, PointNet2Config, tiny_flagship_config
from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.data import roi
from genpose2_tpu_torch.data import synthetic_frame
from genpose2_tpu_torch.data.infer_dataset import frame_to_object_batch
from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.models.fast_encoder import fast_cls_forward
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.ops.fused_sa import (fused_group_mlp_pool, fused_sa_scale,
                                             stage_route)
from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict, scalenet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_W, FRAME_H, FOCAL = 160, 120, 150.0
STEPS = 12


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


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


def _frames(count=3, seed=0):
    """A 160x120 scene of 3 ellipsoids, moved a few mm and about 1 degree per frame."""
    rng = np.random.default_rng(seed)
    objs = synthetic_frame.random_scene(rng, 3, FRAME_W, FRAME_H, FOCAL, depth=(0.5, 0.8))
    frames = []
    for _ in range(count):
        frames.append(synthetic_frame.render(rng, objs, FRAME_W, FRAME_H, FOCAL))
        objs = synthetic_frame.moved(rng, objs)
    return frames


# ----------------------------------------------------------------------- crops
WINDOWS = [((320.0, 240.0), 200.0), ((15.5, 30.0), 160.0), ((630.0, 470.5), 240.0),
           ((-20.0, 100.0), 120.0), ((411.3, 77.9), 97.31)]


@pytest.mark.parametrize("center,scale", WINDOWS)
def test_affine_transform_matches_cv2(center, scale):
    for size in (256, 64):
        for inv in (False, True):
            want = jax_roi.get_affine_transform(np.array(center), scale, 0, (size, size), inv)
            got = roi.get_affine_transform(np.array(center), scale, 0, (size, size), inv)
            # the same LU elimination as cv2.getAffineTransform: bit for bit
            # here, held to 1e-9
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("size", [256, 64])
@pytest.mark.parametrize("what", ["coord", "depth", "mask"])
def test_nearest_crops_equal_cv2(what, size):
    rng = np.random.default_rng(1)
    if what == "coord":  # 2 channels: cv2's fixed-point map
        img = jax_roi.get_2d_coord_np(640, 480).transpose(1, 2, 0)
    elif what == "depth":
        img = rng.uniform(0.3, 1.5, (480, 640)).astype(np.float32)
    else:
        img = (rng.random((480, 640)) < 0.5).astype(np.float32)
    for center, scale in WINDOWS:  # windows partly outside the frame among them
        want = jax_roi.crop_resize_by_warp_affine(img, np.array(center), scale, size,
                                                  interpolation=cv2.INTER_NEAREST)
        got = roi.crop_resize_by_warp_affine(img, np.array(center), scale, size,
                                             interpolation=roi.INTER_NEAREST)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [256, 64])
def test_bilinear_rgb_within_one_level_of_cv2(size):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    differing, total = 0, 0
    for center, scale in WINDOWS:
        want = jax_roi.crop_resize_by_warp_affine(img, np.array(center), scale, size)
        got = roi.crop_resize_by_warp_affine(img, np.array(center), scale, size)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1  # OpenCV's vector code orders the float32 operations otherwise
        differing += int((d > 0).sum())
        total += d.size
    # measured with cv2 5.0: 20 of 983,040 values (256 px), 1 of 61,440 (64 px)
    assert differing <= total // 1000, (differing, total)


@pytest.mark.parametrize("dzi_type", ["uniform", "roi10d", "none"])
def test_dynamic_zoom_in_matches_jax(dzi_type):
    for seed, box in enumerate(([100, 50, 180, 170], [0, 0, 40, 400], [600, 400, 640, 480])):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_roi.aug_bbox_dzi(a, np.array(box), 480, 640, dzi_type=dzi_type)
        got = roi.aug_bbox_dzi(b, np.array(box), 480, 640, dzi_type=dzi_type)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert a.random() == b.random()  # the same number of draws
    with pytest.raises(NotImplementedError):
        roi.aug_bbox_dzi(np.random.default_rng(0), np.array([0, 0, 9, 9]), 480, 640,
                         dzi_type="truncnorm")
    np.testing.assert_array_equal(roi.aug_bbox_eval(np.array([3, 4, 50, 80]), 480, 640)[0],
                                  jax_roi.aug_bbox_eval(np.array([3, 4, 50, 80]), 480, 640)[0])


def test_bbox_coords_and_normalisation_match_jax():
    for box in ([10, 20, 50, 90], [0, 0, 470, 630], [400, 600, 479, 639], [200, 5, 260, 30]):
        assert roi.get_bbox(box, 480, 640) == jax_roi.get_bbox(box, 480, 640)
    np.testing.assert_array_equal(roi.get_2d_coord_np(64, 48, "HWC"),
                                  jax_roi.get_2d_coord_np(64, 48, "HWC"))
    rgb = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(roi.normalize_rgb(rgb), jax_roi.normalize_rgb(rgb))


# ------------------------------------------------------------------- front end
@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_front_end_matches_jax(branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setenv("GP2_DISABLE_NATIVE", "1")
    frame = _frames(1)[0]
    args = (frame["color"], frame["depth"], frame["mask"], frame["intrinsics"])
    want_raw = jax_frame_to_object_batch(*args, jax_flagship_config().data)
    got_raw = frame_to_object_batch(*args, tiny_flagship_config().data)
    want = {k: np.asarray(v) for k, v in jax_process_batch(want_raw).items()}
    got = process_batch(got_raw, device="cpu")
    np.testing.assert_array_equal(got_raw["mask_ids"], want_raw["mask_ids"])
    assert list(got_raw["mask_ids"]) == [1, 2, 3]
    for k in ("pts", "roi_xs", "roi_ys", "gt_pose", "roi_center_dir", "intrinsics"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the mean's float32 sum runs in another order than XLA's: within 2 ulp
    np.testing.assert_allclose(got["pts_center"].numpy(), want["pts_center"], rtol=0, atol=1.2e-7)
    # roi_rgb: bilinear uint8 within one level, normalised (1 / 255 / std)
    np.testing.assert_allclose(got["roi_rgb"].numpy(), want["roi_rgb"], rtol=0,
                               atol=1.01 / 255 / 0.224)


def test_front_end_branches_differ_in_sampling(monkeypatch):
    """The native branch samples with its own generator: a different cloud of
    the same object (so that each branch is tested above)."""
    frame = _frames(1)[0]
    args = (frame["color"], frame["depth"], frame["mask"], frame["intrinsics"],
            tiny_flagship_config().data)
    native = frame_to_object_batch(*args)
    monkeypatch.setenv("GP2_DISABLE_NATIVE", "1")
    plain = frame_to_object_batch(*args)
    assert not np.array_equal(native["pcl_in"], plain["pcl_in"])
    np.testing.assert_array_equal(native["roi_rgb"], plain["roi_rgb"])


def test_port_imports_neither_cv2_nor_jax():
    """The API and its data modules import in an interpreter where cv2 and jax
    cannot be imported."""
    code = textwrap.dedent("""
        import sys
        sys.modules["cv2"] = None
        sys.modules["jax"] = None
        import genpose2_tpu_torch.api
        import genpose2_tpu_torch.eval.tracking
        import genpose2_tpu_torch.data.infer_dataset, genpose2_tpu_torch.data.synthetic_frame
        bad = [m for m in sys.modules if m.split(".")[0] in ("cv2", "jax", "genpose2_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------- dense route
def _jax_route(N, M, mlps, nsamples, radii, dtype):
    """The JAX package's route for one stage, read off a trace of
    fused_sa_stage: per-scale kernels when it calls fused_sa_scale."""
    calls = []

    def spy(xyz, new_xyz, proj, center, aff, w, r, ns, **kw):
        calls.append(r)
        return jnp.zeros((xyz.shape[0], new_xyz.shape[1], aff[-1][0].shape[0]))

    f32 = jnp.float32
    spec = jax.ShapeDtypeStruct
    projs = [spec((1, N, m[0]), dtype) for m in mlps]
    centers = [spec((1, M, m[0]), f32) for m in mlps]
    affs = [[(spec((w,), f32), spec((w,), f32)) for w in m] for m in mlps]
    ws = [[spec((a, b), dtype) for a, b in zip(m[:-1], m[1:])] for m in mlps]
    fn = functools.partial(jax_fused_sa.fused_sa_stage.__wrapped__, radii=tuple(radii),
                           nsamples=tuple(nsamples), slot_chunk=4, dynamic_skip=True)
    orig, jax_fused_sa.fused_sa_scale = jax_fused_sa.fused_sa_scale, spy
    try:
        jax.eval_shape(fn, spec((1, N, 3), f32), spec((1, M, 3), f32), projs, centers, affs, ws)
    finally:
        jax_fused_sa.fused_sa_scale = orig
    return "scale" if calls else "stage"


@pytest.mark.parametrize("config", ["light", "lighter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_points", [1024, 1536, 1664, 2048])
def test_stage_route_is_the_jax_decision(n_points, dtype, config):
    cfg = PointNet2Config() if config == "light" else LIGHTER_POINTNET2
    jcfg = JaxPointNet2Config() if config == "light" else JAX_LIGHTER
    assert cfg.mlps == jcfg.mlps and cfg.nsamples == jcfg.nsamples
    mlps, nsamples, M = cfg.mlps[0], cfg.nsamples[0], cfg.npoints[0]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    projs = [torch.empty(1, n_points, m[0], dtype=tdt, device="meta") for m in mlps]
    affs = [[(torch.empty(w, device="meta"), torch.empty(w, device="meta")) for w in m]
            for m in mlps]
    ws = [[torch.empty(a, b, dtype=tdt, device="meta") for a, b in zip(m[:-1], m[1:])]
          for m in mlps]
    want = _jax_route(n_points, M, mlps, nsamples, cfg.radii[0], jnp.dtype(dtype))
    assert stage_route(n_points, M, projs, affs, ws, nsamples, 4) == want
    if n_points == 2048:  # the dense configuration's stage 0 is per scale in both dtypes
        assert want == "scale"


def _sa_operands(seed, B, N, M, dtype, width=8):
    """A cloud, M of its points as centroids, and one scale's projected
    features, center projections, affines and two layers' weights."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.2, 0.2, size=(B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, rng.choice(N, M, replace=False)]
    proj = rng.normal(size=(B, N, width)).astype(np.float32)
    center = rng.normal(size=(B, M, width)).astype(np.float32)
    affines = [(rng.uniform(0.5, 1.5, width).astype(np.float32),
                rng.normal(0, 0.1, width).astype(np.float32)) for _ in range(3)]
    weights = [(rng.normal(size=(width, width)) / np.sqrt(width)).astype(np.float32)
               for _ in range(2)]
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    jax_args = (jnp.asarray(proj).astype(jdt), jnp.asarray(center),
                [(jnp.asarray(a), jnp.asarray(c)) for a, c in affines],
                [jnp.asarray(w).astype(jdt) for w in weights])
    port_args = (_t(proj).to(pdt), _t(center), [(_t(a), _t(c)) for a, c in affines],
                 [_t(w).to(pdt) for w in weights])
    return xyz, new_xyz, jax_args, port_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ordered", [False, True])
def test_fused_sa_scale_matches_jax(ordered, dtype):
    B, N, M, radius, nsample = 2, 1024, 128, 0.05, 16
    xyz, new_xyz, jargs, pargs = _sa_operands(4, B, N, M, dtype)
    if ordered:  # the dense stage's order: centroids by in-radius count, with the slot skip
        cnt = np.asarray(jax_ball_count(jnp.asarray(xyz), jnp.asarray(new_xyz), radius))
        new_xyz = np.take_along_axis(new_xyz, np.argsort(-cnt, axis=1)[..., None], axis=1)
    want = jax_fused_sa.fused_sa_scale(jnp.asarray(xyz), jnp.asarray(new_xyz), *jargs, radius,
                                       nsample, slot_chunk=4, dynamic_skip=ordered)
    got = fused_sa_scale(_t(xyz), _t(new_xyz), *pargs, radius, nsample)
    assert got.dtype == torch.float32 and got.shape == (B, M, 8)
    # float32: 1e-5 relative; bf16: the same bf16 operands, products
    # summed in another order, which may flip one bf16 rounding of a layer
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_group_mlp_pool_matches_jax(dtype):
    B, N, M, S = 2, 256, 64, 12
    _, _, jargs, pargs = _sa_operands(5, B, N, M, dtype)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, N, size=(B, M, S)).astype(np.int32)
    idx[:, :8, 3] = -1  # outside [0, N): a zero row
    idx[:, 8:16, 5] = N + 7
    idx[:, 16:24, 1:] = idx[:, 16:24, :1]  # one point repeated in every slot
    idx[:, 24:32, 6:] = idx[:, 24:32, :6]  # the first half repeated
    idx[:, 32] = -3  # every slot outside: only the zero row
    want = jax_fused_sa.fused_group_mlp_pool(jargs[0], jnp.asarray(idx), *jargs[1:])
    got = fused_group_mlp_pool(pargs[0], torch.from_numpy(idx), *pargs[1:])
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


DENSE_2048 = dict(
    npoints=(128, 64, 32, 16, None),
    radii=((0.04, 0.08), (0.08, 0.16), (0.16, 0.24), (0.24, 0.32), (None, None)),
    nsamples=((8, 16), (8, 16), (8, 8), (8, 8), (None, None)),
    mlps=(((8, 8, 16), (8, 16, 16)), ((16, 16), (16, 16)), ((16, 16), (16, 16)),
          ((16, 16), (16, 16)), ((16, 32), (16, 32))),
)


def test_dense_encoder_takes_the_scale_route_and_matches_jax(monkeypatch):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, num_points=2048,
                                                  pointnet2=JaxPointNet2Config(**DENSE_2048)))
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, num_points=2048,
                                                  pointnet2=PointNet2Config(**DENSE_2048)))
    model = JaxGFObjectPose(jcfg.model, jax_init_sde(jcfg.sde).marginal_std, "score")
    init = jax.jit(lambda k, b: model.init({"params": k, "aug": k, "dropout": k}, b, False))
    vs = randomize(init(jax.random.PRNGKey(7), {"pts": jnp.zeros((1, 2048, 3)),
                                                "sampled_pose": jnp.zeros((1, 9)),
                                                "t": jnp.full((1, 1), 0.5)}), 7)
    pts = np.random.default_rng(8).uniform(-0.3, 0.3, size=(1, 2048, 3)).astype(np.float32)
    enc = {"params": vs["params"]["pts_encoder"], "batch_stats": vs["batch_stats"]["pts_encoder"]}
    want = np.asarray(jax_fast_cls_forward(enc, jnp.asarray(pts), jcfg.model.pointnet2))

    port = GFObjectPose(pcfg.model, init_sde(pcfg.sde).marginal_std, "score")
    port.load_state_dict(posenet_state_dict(vs, pcfg.model))
    import genpose2_tpu_torch.models.fast_encoder as fe
    routes = []
    real = fe.stage_route
    monkeypatch.setattr(fe, "stage_route", lambda *a: routes.append(real(*a)) or routes[-1])
    got = fast_cls_forward(port.pts_encoder, _t(pts), pcfg.model.pointnet2).numpy()
    assert routes == ["scale", "stage", "stage", "stage"]
    assert _jax_route(2048, 128, DENSE_2048["mlps"][0], DENSE_2048["nsamples"][0],
                      DENSE_2048["radii"][0], jnp.float32) == "scale"
    # 1e-5 relative, of the feature's largest entry
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------------------- API
@pytest.fixture(scope="module")
def api_run():
    """GenPose2TPU and GenPose2 on the same weights and frames: detection,
    then two tracking calls fed with each side's own prev_pose."""
    jcfg, pcfg = jax_flagship_config(), tiny_flagship_config()
    frames = _frames(3)
    # GenPose2TPU's own constructor initialises the agents eagerly (about a
    # minute on the CPU); its inference is what is compared, so the test
    # builds the same attributes from jitted initialisations
    engine = GenPose2TPU.__new__(GenPose2TPU)
    engine.cfg, engine.single_T0, engine.tracking_T0, engine.num_steps = jcfg, 0.55, 0.15, STEPS
    dummy = {"pts": jnp.zeros((1, 128, 3)), "zero_mean_gt_pose": jnp.zeros((1, 9)),
             "pts_center": jnp.zeros((1, 3)), "roi_rgb": jnp.zeros((1, 64, 64, 3)),
             "roi_xs": jnp.zeros((1, 128), jnp.int32), "roi_ys": jnp.zeros((1, 128), jnp.int32)}
    sds = {}
    for name, seed in (("score", 1), ("energy", 2)):
        agent = JaxPoseAgent(jcfg, name)
        state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), dummy)
        vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                        "constants": state.constants}, seed)
        setattr(engine, f"{name}_agent", agent)
        setattr(engine, f"{name}_state", state.replace(
            params=vs["params"], ema_params=vs["params"], batch_stats=vs["batch_stats"],
            constants=vs["constants"]))
        sd = posenet_state_dict(vs, pcfg.model)
        sd.update({f"dino.{k}": v for k, v in
                   dinov3_state_dict(vs["constants"][PROVIDER_KEY]).items()})
        sds[name] = sd
    engine.scale_agent = JaxScaleAgent(jcfg)
    sc_state = engine.scale_agent.init_state(jax.random.PRNGKey(3), pts_dim=128)
    sc_vs = randomize({"params": sc_state.params}, 3)
    engine.scale_state = sc_state.replace(params=sc_vs["params"], ema_params=sc_vs["params"])
    port = GenPose2(pcfg, score=sds["score"], energy=sds["energy"],
                    scale=scalenet_state_dict(sc_vs), num_steps=STEPS, device="cpu")

    def draws(key, n, T0):
        K = jcfg.eval.eval_repeat_num
        prior = jax_init_sde(jcfg.sde).prior_sample(key, (n * K, 9), T=T0)
        t = jax.random.uniform(key, (n * K, 1), jnp.float32, 1e-5, 1e-4)
        return _t(prior), _t(t)

    def run(jax_engine, port_engine, tag):
        out, jprev, pprev = [], None, None
        for i, frame in enumerate(frames):
            key = jax.random.PRNGKey(10 + i)
            tracking = i > 0
            want = jax_engine.inference(frame, prev_pose=jprev, tracking=tracking, key=key)
            T0 = jax_engine.tracking_T0 if tracking else jax_engine.single_T0
            prior, t = draws(key, len(want["mask_ids"]), T0)
            got = port_engine.inference(frame, prev_pose=pprev, tracking=tracking, prior=prior,
                                        energy_t=t)
            jprev, pprev = want["prev_pose"], got["prev_pose"]
            out.append((tag, i, {k: np.asarray(v) for k, v in want.items()},
                        {k: np.asarray(v) for k, v in got.items()}))
        return out

    results = run(engine, port, "full")
    # without the energy and scale agents: score-only aggregation, analytic box sizes
    engine.energy_agent = engine.scale_agent = None
    port.energy_agent = port.scale_agent = None
    results += run(engine, port, "score_only")
    return results


def test_api_matches_jax(api_run):
    for tag, i, want, got in api_run:
        what = f"{tag} call {i}"
        np.testing.assert_array_equal(got["mask_ids"], want["mask_ids"], err_msg=what)
        assert got["pose"].shape == want["pose"].shape == (3, 4, 4)
        # aggregated rotation and translation of candidates that agree to the
        # fused RK4's 5e-4 (tests/test_ode_fused.py:112); a tracking call
        # starts from the previous call's own pose on each side
        np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=2e-3, err_msg=what)
        np.testing.assert_allclose(got["prev_pose"], want["prev_pose"], rtol=0, atol=2e-3,
                                   err_msg=what)
        # box sizes: ScaleNet on features that agree to 2e-4 (the slice's bound),
        # or the cloud's extent along those axes
        np.testing.assert_allclose(got["lengths"], want["lengths"], rtol=2e-3, atol=2e-3,
                                   err_msg=what)
        assert got["lengths"].min() >= 1e-3
