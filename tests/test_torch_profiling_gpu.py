"""The port's spans and counters on the card.

Every test here is marked ``gpu`` and skips inside the test where there is no
card. The module imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_profiling_gpu.py

- in one profiled ``serve_batch``, each span the recorder keeps starts and
  ends within 100 us of its range in the profiler's trace (the two clocks
  differ by one offset);
- ``serve_batch`` reads nothing back to the host; ``_run_one`` reads its
  seven per-object results;
- once warmed up, a loop of ``serve_batch`` calls whose outputs are dropped
  makes no ``cudaMalloc``.
"""

import statistics

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import tiny_flagship_config
from genpose2_tpu_torch.data import synthetic_frame
from genpose2_tpu_torch.utils import profiling
from genpose2_tpu_torch.utils.profiling import recording

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def engine(card):
    """(a tiny flagship GenPose2 on the card, a front-end batch of 3
    objects), warmed up."""
    torch.manual_seed(61)
    eng = GenPose2(tiny_flagship_config(), energy=True, scale=True, num_steps=8, device=card)
    rng = np.random.default_rng(62)
    objs = synthetic_frame.random_scene(rng, 3, 160, 120, 150.0, depth=(0.5, 0.8))
    raw = eng.front_end(synthetic_frame.render(rng, objs, 160, 120, 150.0))
    for _ in range(2):
        eng.serve_batch(raw)
    torch.cuda.synchronize()
    return eng, raw


def test_recorded_spans_lie_on_their_trace_ranges(engine):
    eng, raw = engine
    for _ in range(2):  # the first profiled call also looks the profiler's ops up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with recording() as timer:
                eng.serve_batch(raw)
            torch.cuda.synchronize()
    names = {x.name for x in timer.spans}
    assert {"serve.request", "collate", "score.sample", "energy.rank", "aggregate"} <= names
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CPU and e.is_user_annotation()
                     and e.name() in names), key=lambda r: r[1])
    spans = sorted(timer.spans, key=lambda x: x.start_ns)
    assert [r[0] for r in ranges] == [x.name for x in spans]
    offset = statistics.median(r[1] - x.start_ns for r, x in zip(ranges, spans))
    for (name, k0, k1), x in zip(ranges, spans):
        assert abs(k0 - offset - x.start_ns) < 100_000, name
        assert abs(k1 - offset - x.end_ns) < 100_000, name


def test_serve_batch_reads_nothing_back_and_run_one_reads_its_results(engine, card):
    from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator

    eng, raw = engine
    profiling.reset_counters()
    out = eng.serve_batch(raw)
    torch.cuda.synchronize()
    assert profiling.counters()["host_reads"] == 0
    batch = dict(out["batch"], class_label=torch.zeros(len(raw["mask_ids"]), dtype=torch.int32,
                                                       device=card),
                 gt_rotation=out["aggregate"]["rotation"],
                 gt_translation=out["aggregate"]["translation"],
                 bbox_side_len=out["lengths"],
                 sym_info=torch.zeros(len(raw["mask_ids"]), 4, dtype=torch.int32, device=card))
    ev = SingleFrameEvaluator(eng.cfg, eng.score_agent, eng.energy_agent,
                              lambda b, R, t, pts_feat=None: eng.scale_agent.predict(pts_feat, R))
    profiling.reset_counters()
    with recording():
        ev._run_one(batch)
    c = profiling.counters()
    assert c["host_reads"] == c["unit.host_reads"] == 7 and c["units"] == 1
    assert c["kernel_load_s"] > 0


def test_a_warm_loop_that_keeps_no_output_allocates_nothing(engine):
    eng, raw = engine
    profiling.reset_counters()
    for _ in range(3):
        out = eng.serve_batch(raw)
        del out
    torch.cuda.synchronize()
    c = profiling.counters()
    assert c["cuda_mallocs"] == 0 and c["alloc_retries"] == 0, c
