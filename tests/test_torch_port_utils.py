"""The port's profiling and visualisation utilities, the eval hook's image
grid and the demo, on the CPU, against the JAX package's.

- ``StageTimer``'s summary keys and counts, ``dump``; ``trace_context``
  writing a Chrome trace, and doing nothing for None;
- ``draw_3d_bbox``, ``export_mitsuba_xml``, ``create_grid_image``,
  ``visualize_so3`` and the denoising video's frames against JAX's on the
  same inputs;
- the eval hook's ``eval_img/epoch_1.png`` against the JAX hook's for the
  same aggregate, and ``eval_image_error`` with training going on where
  matplotlib is missing;
- the demo on the CPU writing its two images;
- ``utils/visualize.py`` importing without matplotlib or OpenCV, a drawing
  call then raising an ImportError that names the module.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from genpose2_tpu_torch.utils import visualize as viz
from genpose2_tpu_torch.utils.profiling import StageTimer, trace_context


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


def _scene(seed=0, B=3, N=200):
    """Camera-frame clouds and 9-D poses (rotation's two columns, translation)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, N, 3)) * [0.05, 0.08, 0.03] + [0.0, 0.0, 0.7]).astype(np.float32)

    def pose():
        R = _rotations(rng, B)
        t = rng.normal(size=(B, 3)).astype(np.float32) * 0.02 + [0.0, 0.0, 0.7]
        return np.concatenate([R[:, :, 0], R[:, :, 1], t], -1).astype(np.float32)

    return rng, pts, pose(), pose()


def test_stage_timer_keys_and_counts_match_jax(tmp_path):
    from genpose2_tpu.utils.profiling import StageTimer as JaxStageTimer

    got, want = StageTimer(), JaxStageTimer()
    for timer in (got, want):
        for name, reps in (("encode", 3), ("sample", 2)):
            for _ in range(reps):
                with timer.stage(name, sync_on={"out": [np.zeros(2)]} if timer is want
                                 else {"out": [torch.zeros(2)]}):
                    pass
    g, w = got.summary(), want.summary()
    assert list(g) == list(w) == ["encode", "sample"]
    for k in w:
        assert set(g[k]) == set(w[k]) == {"total_s", "count", "mean_ms"}
        assert g[k]["count"] == w[k]["count"]
    path = tmp_path / "timer.json"
    got.dump(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(g))


def test_trace_context_writes_a_trace_and_none_is_a_no_op(tmp_path):
    with trace_context(None) as path:
        torch.ones(3).sum()
    assert path is None
    with trace_context(str(tmp_path)) as path:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert path.startswith(str(tmp_path / "plugins" / "profile"))
    with open(path) as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_draw_3d_bbox_and_mitsuba_xml_match_jax(tmp_path):
    from genpose2_tpu.utils import visualize as jviz

    rng, pts, pose, _ = _scene(1)
    K = np.array([[280.0, 0, 160], [0, 280.0, 120], [0, 0, 1]], np.float32)
    image = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    R, t, lengths = _rotations(rng, 1)[0], np.array([0.02, -0.01, 0.62]), np.array([0.1, 0.2, 0.08])
    want = jviz.draw_3d_bbox(image, K, R, t, lengths, color=(255, 0, 0), thickness=1)
    got = viz.draw_3d_bbox(torch.from_numpy(image), torch.from_numpy(K), torch.from_numpy(R),
                           torch.from_numpy(t), torch.from_numpy(lengths), color=(255, 0, 0),
                           thickness=1)
    assert np.array_equal(got, want) and not np.array_equal(got, image)
    cloud = rng.normal(size=(5000, 3))
    want = jviz.export_mitsuba_xml(cloud, str(tmp_path / "j.xml"), max_points=1000)
    got = viz.export_mitsuba_xml(torch.from_numpy(cloud), str(tmp_path / "p.xml"),
                                 max_points=1000)
    assert got == want == (tmp_path / "p.xml").read_text()


def _alike(got, want):
    """Equal images but for at most 1e-4 of their values. The inverse-posed
    clouds of torch and of JAX differ in the last float32 bit (6e-8 m here),
    which can move the edge of an equal-aspect axis box by one pixel: the
    renders above differ in 12 pixels of two such edges (36 of 1.44M
    values)."""
    return float((got != want).mean()) <= 1e-4


def test_grid_so3_and_video_frames_match_jax(tmp_path):
    from genpose2_tpu.utils import visualize as jviz

    rng, pts, pred, gt = _scene(2)
    got = viz.create_grid_image(torch.from_numpy(pts), torch.from_numpy(pred), torch.from_numpy(gt),
                                path=str(tmp_path / "grid.png"))
    want = jviz.create_grid_image(pts, pred, gt)
    assert got.shape == want.shape
    assert _alike(got, want)
    assert os.path.getsize(tmp_path / "grid.png") > 0
    Rs = _rotations(rng, 32)
    got = viz.visualize_so3(torch.from_numpy(Rs), Rs[0])
    assert np.array_equal(got, jviz.visualize_so3(Rs, Rs[0]))
    trajectory = [pred, gt]
    frames = viz.denoising_frames([torch.from_numpy(p) for p in trajectory], pts)
    for f, p in zip(frames, trajectory):
        assert _alike(f, jviz.create_grid_image(pts, pred_pose=p))
    video = tmp_path / "denoise.mp4"
    viz.save_denoising_video(trajectory, pts, str(video))
    import cv2

    cap = cv2.VideoCapture(str(video))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 2
    cap.release()


def _hook_inputs(seed=3, B=3):
    rng, pts, pred, gt = _scene(seed, B)
    center = pts.mean(1)
    R = _rotations(rng, 2 * B)
    t = rng.normal(size=(2 * B, 3)).astype(np.float32) * 0.02 + [0.0, 0.0, 0.7]
    batch = {"pts": pts - center[:, None], "pts_center": center, "gt_rotation": R[:B],
             "gt_translation": t[:B].astype(np.float32)}
    agg = {"rotation": R[B:], "translation": t[B:].astype(np.float32)}
    return batch, agg


class _PortAgent:
    device = torch.device("cpu")

    def sample_candidates(self, batch, repeat_num, **kw):
        return torch.zeros(batch["pts"].shape[0], repeat_num, 9)


class _JaxAgent:
    def sample_candidates(self, state, batch, key, repeat_num, **kw):
        import jax.numpy as jnp

        return jnp.zeros((batch["pts"].shape[0], repeat_num, 9))


def _port_hook(monkeypatch, log_dir, batch, agg):
    from genpose2_tpu_torch.config import tiny_test_config
    from genpose2_tpu_torch.training import eval_hooks

    monkeypatch.setattr(eval_hooks, "aggregate_candidates",
                        lambda *a, **k: {k2: torch.from_numpy(v) for k2, v in agg.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fn = eval_hooks.make_sampling_eval_fn(_PortAgent(), tiny_test_config(), lambda e: tb,
                                          log_dir=str(log_dir), repeat_num=4, num_steps=2)
    return fn(None, 1)


def test_eval_hook_grid_matches_jax(monkeypatch, tmp_path):
    import jax.numpy as jnp
    import matplotlib.image

    from genpose2_tpu.config import tiny_test_config as jax_tiny_config
    from genpose2_tpu.training import eval_hooks as jhooks

    batch, agg = _hook_inputs()
    monkeypatch.setattr(jhooks, "aggregate_candidates",
                        lambda *a, **k: {k2: jnp.asarray(v) for k2, v in agg.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jhooks.make_sampling_eval_fn(_JaxAgent(), jax_tiny_config(), lambda e: jb,
                                        log_dir=str(tmp_path / "jax"), repeat_num=4,
                                        num_steps=2)(None, 1)
    got = _port_hook(monkeypatch, tmp_path / "port", batch, agg)
    assert "eval_image_error" not in got and "eval_image_error" not in want
    for k in ("eval_deg_mean", "eval_sht_mean_cm"):
        assert abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])), k
    img = [(matplotlib.image.imread(str(tmp_path / d / "eval_img" / "epoch_1.png")) * 255
            ).round().astype(np.uint8) for d in ("port", "jax")]
    assert img[0].shape == img[1].shape
    assert _alike(*img)


def test_eval_hook_without_matplotlib_records_the_error(monkeypatch, tmp_path):
    batch, agg = _hook_inputs()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = _port_hook(monkeypatch, tmp_path, batch, agg)
    assert got["eval_image_error"] == 0.0 and np.isfinite(got["eval_deg_mean"])
    assert not (tmp_path / "eval_img" / "epoch_1.png").exists()


@pytest.mark.parametrize("hidden,call", [
    ("matplotlib", lambda: viz.visualize_so3(np.eye(3)[None])),
    ("cv2", lambda: viz.draw_3d_bbox(np.zeros((8, 8, 3), np.uint8), np.eye(3), np.eye(3),
                                     np.array([0, 0, 1.0]), np.ones(3))),
])
def test_visualize_imports_without_its_drawing_modules(monkeypatch, hidden, call):
    for name in [m for m in sys.modules if m == hidden or m.startswith(hidden + ".")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, hidden, None)
    monkeypatch.delitem(sys.modules, "genpose2_tpu_torch.utils.visualize")
    mod = importlib.import_module("genpose2_tpu_torch.utils.visualize")
    monkeypatch.setattr(sys.modules[__name__], "viz", mod)
    with pytest.raises(ImportError, match=hidden):
        call()


def test_demo_writes_its_two_images(tmp_path):
    from genpose2_tpu_torch import demo

    out = demo.main(["--device", "cpu", "--out", str(tmp_path), "--trained",
                     "--train_steps", "2"])
    assert out["pose"].shape == (1, 4, 4) and np.isfinite(out["pose"]).all()
    for name in ("bbox_overlay.png", "so3_candidates.png"):
        assert os.path.getsize(tmp_path / name) > 0
