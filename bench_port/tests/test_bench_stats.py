"""Percentiles and rates over every sample of a window, a stall included;
the trace's busy union and idle gaps."""

import numpy as np
import pytest

from bench_port.harness.readers import unit_ms_percentile, work_rate
from bench_port.harness.runner import Context, Unit
from bench_port.harness.stats import percentile, rate
from bench_port.harness.trace import Spans, reduce_events


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(3).exponential(300.0, size=101))
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def _ctx(durations, work=1.0):
    ctx = Context(cell=None, seed=0, seconds=0.0, trace=False, device="cpu", spans=Spans(False))
    t = 0.0
    for d in durations:
        ctx.units.append(Unit(t, t + d, {"items": work}))
        t += d
    ctx.window_s = t
    return ctx


def test_a_stall_shows_in_the_tail_and_the_rate():
    steady = [0.35] * 99
    stalled = steady[:50] + [5.0] + steady[50:]  # one 5-s stall among 100 frames
    a, b = _ctx(steady), _ctx(stalled)
    assert unit_ms_percentile(a, 90) == pytest.approx(350.0)
    assert work_rate(a, "items") == pytest.approx(1 / 0.35)
    # the rate is over all the window's time: the stall costs it 4.65 s of 39.65
    assert work_rate(b, "items") == pytest.approx(100 / (99 * 0.35 + 5.0))
    assert unit_ms_percentile(b, 100) == pytest.approx(5000.0)
    # ten 2-s stalls among 100 frames move p90, which a median of chunks would not
    c = _ctx([0.35] * 45 + [2.0] * 10 + [0.35] * 45)
    assert unit_ms_percentile(c, 90) == pytest.approx(350.0 + 0.1 * (2000.0 - 350.0))


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        rate(1.0, 0.0)


def test_busy_is_the_union_and_gaps_are_labelled():
    dev = [("rk4_kernel", 10, 30), ("sa_kernel<float, 2, false, 4>", 20, 40),
           ("Memcpy HtoD", 60, 70)]
    host = [("sampler.sample_candidates", 0, 50, True), ("agents.scale", 50, 100, True),
            ("cudaStreamSynchronize", 45, 58, False)]
    dt = reduce_events(dev, host, (0, 100))
    assert dt.busy_s == pytest.approx(40e-9)
    assert dt.window_s == pytest.approx(100e-9)
    assert dt.launches == 2  # the copy is no kernel
    assert dt.kernel_count == {"rk4_kernel": 1, "sa_kernel<float, 2, false, 4>": 1}
    labels = dict(dt.idle_gaps)
    assert labels["agents.scale"] == pytest.approx(30e-9)  # 70-100
    assert labels["agents.scale > cudaStreamSynchronize"] == pytest.approx(20e-9)  # 40-60
    assert labels["sampler.sample_candidates"] == pytest.approx(10e-9)  # 0-10
