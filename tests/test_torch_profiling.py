"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- with neither the profiler nor the recorder on, a span enters no
  ``record_function``;
- under ``torch.profiler`` a span is a range of the trace; in the recorder
  spans keep their nesting, parents, unit ids and self time;
- ``host_reads`` counts reads of device tensors only, unit spans count what
  moved inside them only while tracing, ``reset_counters`` leaves the
  process-wide kernel counters;
- ``GenPose2.serve_batch`` and ``SingleFrameEvaluator._run_one`` open the
  spans of their stages, in one unit each.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.utils import profiling
from genpose2_tpu_torch.utils.profiling import recording, span, to_host


@pytest.fixture
def fresh():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture
def device_reads(monkeypatch):
    """Tensors that stand for device tensors: 'meta' tensors whose copy to
    the host is a zero tensor of their shape (the CPU build has no device)."""
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self: torch.zeros(self.shape))
    return lambda *shape: torch.empty(*shape, device="meta")


def _ranges(prof, names):
    """(name, start_ns, end_ns) of the trace's ranges of ``names``, in order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name() in names]
    return sorted(out, key=lambda r: r[1])


def test_a_span_with_nothing_on_enters_no_record_function(monkeypatch, fresh):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled and profiling._recorder is None

    @span("decorated", unit=True)
    def work(x):
        with span("inner"):
            return x + 1

    assert work(1) == 2
    with span("plain"):
        pass
    assert profiling.counters()["units"] == 0


def test_spans_are_ranges_of_the_profilers_trace(fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", unit=True):
            with span("inner"):
                torch.ones(8).sum()
        with span("after"):
            pass
    (o, o0, o1), (i, i0, i1), (a, a0, a1) = _ranges(prof, {"outer", "inner", "after"})
    assert (o, i, a) == ("outer", "inner", "after")
    assert o0 <= i0 < i1 <= o1 <= a0 < a1
    assert profiling.counters()["units"] == 1


def test_the_recorder_keeps_nesting_parents_units_and_self_time(fresh):
    with recording() as timer:
        with span("free"):
            pass
        for _ in range(2):
            with span("request", unit=True):
                with span("encode"):
                    with span("backbone"):
                        sum(range(2000))
                with span("sample"):
                    sum(range(2000))
    assert profiling._recorder is None
    s = timer.spans
    assert [x.name for x in s] == ["free"] + ["request", "encode", "backbone", "sample"] * 2
    assert [x.parent for x in s] == [None, None, 1, 2, 1, None, 5, 6, 5]
    assert s[0].unit is None
    assert {x.unit for x in s[1:5]} == {s[1].unit} and {x.unit for x in s[5:]} == {s[5].unit}
    assert s[1].unit != s[5].unit
    for x in s:
        assert x.end_ns is not None and x.start_ns <= x.end_ns
        if x.parent is not None:
            p = s[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns

    def dur(i):
        return s[i].end_ns - s[i].start_ns

    self_s = timer.self_s()
    want_request = sum(dur(r) - dur(r + 1) - dur(r + 3) for r in (1, 5)) * 1e-9
    want_encode = sum(dur(e) - dur(e + 1) for e in (2, 6)) * 1e-9
    assert self_s["request"] == pytest.approx(want_request, rel=1e-9, abs=1e-12)
    assert self_s["encode"] == pytest.approx(want_encode, rel=1e-9, abs=1e-12)
    assert self_s["backbone"] == pytest.approx((dur(3) + dur(7)) * 1e-9, rel=1e-9)
    assert all(v >= 0 for v in self_s.values())
    summary = timer.summary()
    assert summary["request"]["count"] == 2 and summary["free"]["count"] == 1
    assert set(summary["sample"]) == {"total_s", "count", "mean_ms"}
    assert summary["request"]["total_s"] == pytest.approx((dur(1) + dur(5)) * 1e-9, abs=1e-4)


def test_recorder_and_profiler_see_the_same_spans(fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as timer:
        with span("request", unit=True):
            for _ in range(3):
                with span("step"):
                    torch.ones(16).cumsum(0)
    got = _ranges(prof, {"request", "step"})
    assert [r[0] for r in got] == [x.name for x in timer.spans]
    for (_, k0, k1), x in zip(got, timer.spans):
        assert k0 < k1 and x.start_ns < x.end_ns


def test_host_reads_count_device_tensors_only(fresh, device_reads):
    with recording() as timer:
        host = to_host(torch.arange(3.0))
        assert profiling.counters()["host_reads"] == 0
        assert torch.equal(host, torch.arange(3.0))
        read = to_host(device_reads(2, 3))
    assert read.shape == (2, 3) and read.device.type == "cpu"
    assert profiling.counters()["host_reads"] == 1
    assert [x.name for x in timer.spans] == ["host_read"]


def test_unit_spans_count_what_moved_inside_them_only_while_tracing(fresh, device_reads):
    with span("request", unit=True):
        to_host(device_reads(1))
    c = profiling.counters()
    assert (c["host_reads"], c["units"]) == (1, 0)
    with recording():
        to_host(device_reads(1))  # outside any unit
        with span("request", unit=True):
            for _ in range(7):
                to_host(device_reads(1))
        with span("request", unit=True):
            pass
    c = profiling.counters()
    assert c["host_reads"] == 9
    assert (c["units"], c["unit.host_reads"], c["unit.cuda_mallocs"]) == (2, 7, 0)


def test_reset_leaves_the_kernel_counters(fresh, device_reads, monkeypatch):
    monkeypatch.setattr(profiling, "_process", collections.Counter())
    profiling.note_kernel_load("fps", 0.25, built=True)
    profiling.note_kernel_load("fps_again", 0.5, built=False)
    _cuda.launch_counts["fps"] += 2
    to_host(device_reads(1))
    c = profiling.counters()
    assert c["launches.fps"] == 2 and c["host_reads"] == 1
    profiling.reset_counters()
    c = profiling.counters()
    assert "launches.fps" not in c and c["host_reads"] == 0 and c["units"] == 0
    assert c["kernel_builds.fps"] == c["kernel_builds"] == 1
    assert "kernel_builds.fps_again" not in c and c["kernel_load_s"] == 0.75
    assert c["cuda_mallocs"] == c["alloc_retries"] == 0  # no CUDA here


def test_serve_batch_opens_its_stages_in_one_unit(fresh):
    from genpose2_tpu_torch.api import GenPose2
    from genpose2_tpu_torch.config import tiny_flagship_config
    from genpose2_tpu_torch.data import synthetic_frame

    cfg = tiny_flagship_config()
    torch.manual_seed(3)
    eng = GenPose2(cfg, energy=True, scale=True, num_steps=2, device="cpu")
    rng = np.random.default_rng(4)
    objs = synthetic_frame.random_scene(rng, 2, 160, 120, 150.0, depth=(0.5, 0.8))
    raw = eng.front_end(synthetic_frame.render(rng, objs, 160, 120, 150.0))
    with recording() as timer:
        eng.serve_batch(raw)
    s = timer.spans
    names = [x.name for x in s]
    assert names[0] == "serve.request" and s[0].parent is None
    assert set(names) == {"serve.request", "collate", "backbone", "score.encode",
                          "score.sample", "energy.rank", "energy.encode", "aggregate",
                          "scale.predict"}
    assert {x.unit for x in s} == {s[0].unit} and s[0].unit is not None
    parent = {x.name: names[x.parent] for x in s if x.parent is not None}
    for name in ("collate", "backbone", "score.encode", "aggregate", "scale.predict"):
        assert parent[name] == "serve.request"
    assert parent["energy.encode"] == "energy.rank"
    assert names.count("backbone") == 1  # the energy agent reuses the batch's features
    assert profiling.counters()["host_reads"] == 0


def test_run_one_opens_its_stages_in_one_unit(fresh):
    from genpose2_tpu_torch.config import tiny_test_config
    from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
    from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator
    from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent

    cfg = tiny_test_config()
    torch.manual_seed(5)
    s, e = PoseAgent(cfg, "score", device="cpu"), PoseAgent(cfg, "energy", device="cpu")
    g = torch.Generator().manual_seed(6)
    batch = SyntheticPoseData(cfg.model.num_points, "box").batch(g, 2)
    batch["class_label"] = torch.zeros(2, dtype=torch.int32)
    sc = ScaleAgent(cfg, pts_dim=s.extract_features(batch)[0].shape[-1], device="cpu")
    ev = SingleFrameEvaluator(cfg, s, e, lambda b, R, t, pts_feat=None: sc.predict(pts_feat, R))
    with recording() as timer:
        out = ev._run_one(batch, generator=g)
    names = [x.name for x in timer.spans]
    assert names[0] == "eval.batch"
    assert set(names) == {"eval.batch", "score.encode", "score.sample", "energy.rank",
                          "energy.encode", "aggregate", "scale.predict", "criterion"}
    assert {x.unit for x in timer.spans} == {timer.spans[0].unit}
    assert set(out) == {"rotation", "translation", "lengths", "iou", "deg", "sht", "class_label"}
    assert profiling.counters()["host_reads"] == 0  # every tensor here is on the host
