"""The port's training loop, checkpoints and command line on the CPU.

- ``Trainer.fit``: two epochs in one run equal one epoch, a resume from its
  checkpoint and a second epoch, bit for bit (every parameter, BatchNorm
  statistic, EMA entry and Adam moment).
- ``load_params_only``: the checkpoint's params or, with
  ``use_ema_as_params``, its EMA weights; a reference ``.pth`` through
  ``api.py``'s loaders (``dino.*`` into the backbone).
- The energy agent's warm start from a score checkpoint zeroes its heads.
- The command line on ``--device cpu``, driven as a user drives it (its
  ``main``; ``build_config`` patched to the tiny configs, as
  tests/test_cli_wiring.py patches the JAX CLI's): train score -> scale ->
  energy with ranking -> three-agent eval -> track, from synthetic batches
  and from Omni6DPose frames on disk, writing what tests/test_cli_wiring.py
  checks for the JAX CLI; the resume flag; a ``python -m`` run.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genpose2_tpu_torch import cli
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.data import synthetic_frame
from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.training.checkpoint import is_torch_checkpoint, load_params_only
from genpose2_tpu_torch.training.eval_hooks import make_sampling_eval_fn
from genpose2_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE = 2


def _state_tensors(st):
    opt = [t for k, v in st.opt_state.items() if k != "count" for t in v]
    return [*st.params.values(), *st.buffers.values(), *st.ema_params.values(), *opt]


def _randomize(agent, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
        if agent.provider is not None:
            for p in agent.provider.vit.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.02)


def _synthetic_loader(cfg):
    data = SyntheticPoseData(num_points=cfg.model.num_points)

    def loader_fn(epoch):
        for i in range(SPE):
            yield data.batch(torch.Generator().manual_seed(100 * epoch + i), 4)

    return loader_fn


def _trainer(cfg, log_dir, seed=0, **kw):
    torch.manual_seed(seed)  # module initialisation, the fixed Fourier projections included
    tr = Trainer(cfg, "score", steps_per_epoch=SPE, device="cpu", log_dir=str(log_dir), **kw)
    _randomize(tr.agent, 1)  # before init: a resume then overwrites it
    tr.init()
    return tr


def test_fit_resumes_bit_for_bit(tmp_path):
    cfg = tiny_test_config()  # dropout and input jitter on: the epoch's generator matters
    whole = _trainer(cfg, tmp_path / "whole")
    whole.fit(_synthetic_loader(cfg), epochs=2)
    first = _trainer(cfg, tmp_path / "first")
    first.fit(_synthetic_loader(cfg), epochs=1)
    ckpt = tmp_path / "first" / "ckpt" / "final"
    assert os.path.exists(tmp_path / "first" / "ckpt" / "epoch_1") and os.path.exists(ckpt)
    # another initialisation: the checkpoint restores all of it
    resumed = _trainer(cfg, tmp_path / "resumed", seed=1, resume_from=str(ckpt))
    assert resumed.state.step == SPE
    resumed.fit(_synthetic_loader(cfg), epochs=2)
    assert resumed.state.step == whole.state.step == 2 * SPE
    assert resumed.state.ema_updates == whole.state.ema_updates
    assert resumed.state.opt_state["count"] == whole.state.opt_state["count"]
    for a, b in zip(_state_tensors(resumed.state), _state_tensors(whole.state)):
        assert torch.equal(a, b)
    got, want = resumed.agent.model.state_dict(), whole.agent.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the epoch records
    with open(tmp_path / "whole" / "score_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs if "epoch_time_s" in r] == [1, 2]


def test_load_params_only(tmp_path):
    cfg = tiny_flagship_config()
    tr = _trainer(cfg, tmp_path)
    tr.fit(_flagship_loader(cfg), epochs=1)
    path = tr.save("x")
    src = torch.load(path, weights_only=True)
    assert set(src) >= {"step", "params", "buffers", "opt_state", "ema_params", "ema_updates",
                        "constants", "dino"}
    assert any(k.endswith(".W") for k in src["constants"])  # the Fourier projections
    for use_ema in (False, True):
        torch.manual_seed(5)
        agent = PoseAgent(cfg, "score", "cpu")
        state = agent.init_state()
        load_params_only(path, state, use_ema_as_params=use_ema, agent=agent)
        want = src["ema_params" if use_ema else "params"]
        assert all(torch.equal(state.params[k], want[k]) for k in want)
        assert all(torch.equal(state.ema_params[k], src["ema_params"][k]) for k in want)
        assert all(torch.equal(state.buffers[k], src["buffers"][k]) for k in src["buffers"])
        own = agent.model.state_dict()
        assert all(torch.equal(own[k], v) for k, v in src["constants"].items())
        assert state.step == 0 and state.opt_state["count"] == 0
        vit = agent.provider.vit.state_dict()
        assert all(torch.equal(vit[k], v) for k, v in src["dino"].items())
    # a reference .pth (wrapped, dino.* included) through api.py's loaders
    sd = dict(tr.agent.model.state_dict())
    sd.update({f"dino.{k}": v for k, v in tr.agent.provider.vit.state_dict().items()})
    pth = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd}, pth)
    assert is_torch_checkpoint(pth) and not is_torch_checkpoint(path)
    agent = PoseAgent(cfg, "score", "cpu")
    state = load_params_only(pth, agent.init_state(), agent=agent)
    got = agent.model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in got)
    assert all(torch.equal(state.ema_params[k], p) for k, p in state.params.items())
    with pytest.raises(ValueError):
        load_params_only(pth, state)


def _flagship_loader(cfg):
    """Prepared flagship batches: synthetic clouds with random crops."""
    base = _synthetic_loader(cfg)
    S, N = cfg.model.img_size, cfg.model.num_points

    def loader_fn(epoch):
        g = torch.Generator().manual_seed(epoch)
        for b in base(epoch):
            yield dict(b, roi_rgb=torch.randn(4, S, S, 3, generator=g),
                       roi_xs=torch.randint(0, S, (4, N), generator=g),
                       roi_ys=torch.randint(0, S, (4, N), generator=g))

    return loader_fn


def test_energy_warm_start_and_eval_hook(tmp_path):
    cfg = tiny_flagship_config()
    score = _trainer(cfg, tmp_path / "score")
    score.fit(_flagship_loader(cfg), epochs=1)
    ckpt = score.save("warm")
    energy = Trainer(cfg, "energy", steps_per_epoch=SPE, device="cpu",
                     log_dir=str(tmp_path / "energy"), score_ckpt=ckpt)
    energy.init()
    net = energy.agent.model.pose_score_net
    heads = {f"pose_score_net.{h}.{len(getattr(net, h)) - 1}." for h in net.head_names()}
    for k, p in energy.state.params.items():
        if any(k.startswith(h) for h in heads):
            assert not p.any(), k
        else:
            assert torch.equal(p, score.state.params[k]), k
        assert torch.equal(energy.state.ema_params[k], p)
    vit_e, vit_s = energy.agent.provider.vit.state_dict(), score.agent.provider.vit.state_dict()
    assert all(torch.equal(vit_e[k], vit_s[k]) for k in vit_s)
    batch = next(_flagship_loader(cfg)(5))
    batch = dict(batch, gt_rotation=batch["gt_rotation"], pts=batch["cam_pts"])
    out = make_sampling_eval_fn(score.agent, cfg, lambda e: batch, repeat_num=3,
                                num_steps=4)(score.state, 3)
    assert set(out) == {"eval_deg_mean", "eval_deg_median", "eval_sht_mean_cm",
                        "eval_iou_mean"}
    assert all(np.isfinite(v) for v in out.values())


# ------------------------------------------------------------ command line
# argparse keeps a flag's last value: a call overrides these after them
BASE_FLAGS = ["--batch_size", "4", "--seed", "0", "--sampling_steps", "5", "--n_epochs", "1",
              "--repeat_num", "2", "--eval_repeat_num", "4", "--retain_ratio", "0.5",
              "--steps_per_epoch", "3", "--warmup", "5", "--device", "cpu"]


@pytest.fixture()
def tiny_build_config(monkeypatch):
    """build_config with the tiny configs (tiny_flagship_config for
    --dino pointwise, else tiny_test_config); the flags that the commands
    read are applied as the real build_config applies them."""
    real = cli.build_config

    def fake_build_config(args):
        full = real(args)
        cfg = tiny_flagship_config() if args.dino == "pointwise" else tiny_test_config()
        data = dataclasses.replace(full.data, num_points=cfg.model.num_points,
                                   img_size=cfg.model.img_size)
        train = dataclasses.replace(full.train, batch_size=args.batch_size)
        return cfg.replace(train=dataclasses.replace(
            train, repeat_num=args.repeat_num, ranking_num=cfg.train.ranking_num),
            eval=full.eval, sampler=full.sampler, data=data, log_dir=args.log_dir)

    monkeypatch.setattr(cli, "build_config", fake_build_config)


def _chain(tmp_path, data_flags, track_path=None):
    """train score -> scale -> energy with ranking -> eval -> track."""
    d = str(tmp_path)
    cli.main(["train", "--agent_type", "score", "--log_dir", f"{d}/score", *data_flags,
              *BASE_FLAGS, "--n_epochs", "2", "--eval_freq", "1"])
    score = f"{d}/score/ckpt/final"
    assert os.path.exists(score) and os.path.exists(f"{d}/score/ckpt/epoch_1")
    with open(f"{d}/score/score_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert any("eval_deg_mean" in r for r in recs) and any("epoch_time_s" in r for r in recs)
    cli.main(["train", "--agent_type", "scale", "--log_dir", f"{d}/scale", "--score_ckpt",
              score, *data_flags, *BASE_FLAGS])
    cli.main(["train", "--agent_type", "energy_with_ranking", "--log_dir", f"{d}/energy",
              "--score_ckpt", score, *data_flags, *BASE_FLAGS])
    ckpts = ["--score_ckpt", score, "--energy_ckpt", f"{d}/energy/ckpt/final",
             "--scale_ckpt", f"{d}/scale/ckpt/final"]
    metrics = cli.main(["eval", "--log_dir", f"{d}/evalrun", *ckpts, *data_flags, *BASE_FLAGS])
    with open(f"{d}/evalrun/eval/metrics.json") as f:
        blob = json.load(f)
    assert np.isfinite(blob["deg_mean"]) and "pose_auc" in blob
    assert np.isfinite(metrics.deg_mean)
    assert os.path.exists(f"{d}/evalrun/eval/batch_000000.npz")
    if track_path is not None:
        flags = [f if f != data_flags[-1] else track_path for f in data_flags]
        tm = cli.main(["track", "--log_dir", f"{d}/track", *ckpts, *flags, *BASE_FLAGS,
                       "--T0", "0.25"])
        assert np.isfinite(tm.deg_mean) and np.isfinite(tm.sht_mean)


def test_cli_chain_synthetic(tiny_build_config, tmp_path):
    _chain(tmp_path, ["--source", "synthetic", "--data_path", ""])


@pytest.fixture(scope="module")
def disk_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("omni_disk"))
    return synthetic_frame.write_dataset(root, np.random.default_rng(3), 3, (2, 3), width=160,
                                         height=120, f=150.0, videos=2, video_frames=3,
                                         depth=(0.5, 0.8))


def test_cli_chain_from_files(tiny_build_config, tmp_path, disk_data):
    _chain(tmp_path, ["--source", "Omni6DPose", "--dino", "pointwise", "--data_path",
                      disk_data["frames"]], track_path=disk_data["videos"])
    # the resume flag: one more epoch from the saved state
    d = str(tmp_path)
    cli.main(["train", "--agent_type", "score", "--log_dir", f"{d}/r2", "--use_pretrain",
              "--pretrain_path", f"{d}/score/ckpt/final", "--source", "Omni6DPose",
              "--dino", "pointwise", "--data_path", disk_data["frames"], *BASE_FLAGS,
              "--n_epochs", "3"])
    with open(f"{d}/r2/score_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f if "epoch_time_s" in line]
    assert [r["epoch"] for r in recs] == [3]


def test_cli_refuses_what_is_not_ported(tiny_build_config, tmp_path):
    """What cannot run raises before any rank starts: a global batch that the
    ranks do not divide, and --multihost beside --data_parallel (a rank a
    process). Data-parallel training itself: tests/test_torch_port_parallel.py."""
    with pytest.raises(ValueError, match="divisible"):
        cli.main(["train", *BASE_FLAGS, "--data_parallel", "3"])
    with pytest.raises(ValueError, match="one rank"):
        cli.main(["train", *BASE_FLAGS, "--multihost", "--data_parallel", "2"])


def test_python_m_cli_runs_on_the_cpu(tmp_path):
    """``python -m genpose2_tpu_torch.cli train`` with the real config on
    --device cpu (dino='none', the smallest cloud its stages take)."""
    out = subprocess.run(
        [sys.executable, "-m", "genpose2_tpu_torch.cli", "train", "--source", "synthetic",
         "--device", "cpu", "--batch_size", "2", "--num_points", "512", "--n_epochs", "1",
         "--steps_per_epoch", "1", "--repeat_num", "1", "--eval_repeat_num", "2",
         "--sampling_steps", "2", "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.exists(tmp_path / "ckpt" / "final")
