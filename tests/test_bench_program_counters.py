"""The benchmark's readers of the program's own spans and counters, on the
CPU (``bench_port/``'s per-layer metrics ``host_reads_per_batch.eval``,
``cuda_mallocs_per_batch.eval``, ``cuda_mallocs_per_request.serve`` and
``kernel_load_s``; ``harness/span_idle.py``; ``tools/program_spans.py``).

- on a fixed list of events, ``trace.reduce_events`` gives its fields as
  before and ``span_idle_s`` the exact idle time inside each span name, for
  overlapping ranges and gaps that a range covers in part;
- each new reader returns None on an untraced context, and on a traced one
  reads what the program's unit spans counted;
- the tool runs a tiny cell's windows in each mode.
"""

import pytest
import torch

from bench_port.harness.manifest import load_reader
from bench_port.harness.runner import Context, Unit
from bench_port.harness.span_idle import idle_outside_s, span_idle_s
from bench_port.harness.trace import DeviceTrace, Spans, reduce_events
import bench_port.conftest  # noqa: F401  (the tiny size of eval_streaming_ref's cells)
from bench_port.tests.helpers import manifest, tiny_cell
from genpose2_tpu_torch.utils import profiling
from genpose2_tpu_torch.utils.profiling import recording, span, to_host

NEW = ("host_reads_per_batch.eval", "cuda_mallocs_per_batch.eval",
       "cuda_mallocs_per_request.serve", "kernel_load_s")

# device busy 10-30, 20-40 (union 10-40) and 60-70 in a window 0-100: idle 0-10, 40-60, 70-100
DEVICE = [("rk4_kernel", 10, 30), ("sa_kernel<float, 2, false, 4>", 20, 40),
          ("Memcpy HtoD", 60, 70)]
HOST = [("sampler.sample_candidates", 0, 50, True), ("agents.scale", 50, 100, True),
        ("cudaStreamSynchronize", 45, 58, False),
        ("aggregate", 5, 15, True), ("aggregate", 8, 45, True),  # overlapping: 5-45
        ("aggregate", 65, 80, True),  # a gap's part: 70-80
        ("criterion", 90, 130, True)]  # past the window's end


def test_reduce_events_keeps_its_fields():
    dt = reduce_events(DEVICE, HOST, (0, 100))
    assert dt.busy_s == pytest.approx(40e-9) and dt.window_s == pytest.approx(100e-9)
    assert dt.launches == 2 and dt.kernel_count == {"rk4_kernel": 1,
                                                    "sa_kernel<float, 2, false, 4>": 1}
    assert dt.kernel_s["Memcpy HtoD"] == pytest.approx(10e-9)
    labels = dict(dt.idle_gaps)
    assert labels["agents.scale"] == pytest.approx(30e-9)  # 70-100, labelled at 85
    assert labels["agents.scale > cudaStreamSynchronize"] == pytest.approx(20e-9)  # 40-60
    assert labels["aggregate"] == pytest.approx(10e-9)  # 0-10, labelled at 5
    assert dict(dt.device_ops)["rk4_kernel"] == pytest.approx(20e-9)


def test_span_idle_is_the_exact_intersection():
    got = span_idle_s(DEVICE, HOST, (0, 100))
    want = {"sampler.sample_candidates": 20e-9,  # 0-10, 40-50
            "agents.scale": 40e-9,  # 50-60, 70-100
            "aggregate": 20e-9,  # 5-10, 40-45, 70-80
            "criterion": 10e-9}  # 90-100
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-15), k
    assert span_idle_s(DEVICE, HOST, (0, 100), names=["aggregate"]).keys() == {"aggregate"}
    # idle 60 ns; aggregate or criterion cover 5-10, 40-45, 70-80, 90-100
    assert idle_outside_s(DEVICE, HOST, (0, 100), ["aggregate", "criterion"]) == \
        pytest.approx(30e-9, abs=1e-15)
    assert idle_outside_s(DEVICE, HOST, (0, 100), []) == pytest.approx(60e-9, abs=1e-15)


def _ctx(traced: bool, units: int = 1) -> Context:
    ctx = Context(cell=None, seed=0, seconds=0.0, trace=traced, device="cpu", spans=Spans(False))
    ctx.units = [Unit(float(i), float(i + 1), {"candidates": 1.0}) for i in range(units)]
    ctx.window_s = float(units)
    ctx.device_trace = DeviceTrace(window_s=1.0, busy_s=0.5) if traced else None
    return ctx


def test_the_new_entries_name_their_readers():
    entries = {m["name"]: m for m in manifest()["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_counter" and entries[name]["workloads"]
        assert callable(load_reader(name).read)


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_finds_nothing_in_an_untraced_run(name):
    profiling.reset_counters()
    with recording():
        with span("unit", unit=True):
            pass
    assert load_reader(name).read(_ctx(False)) is None


def test_the_new_readers_read_the_program_s_unit_counts(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self: torch.zeros(self.shape))
    profiling.reset_counters()
    ctx = _ctx(True, units=2)
    assert load_reader("host_reads_per_batch.eval").read(ctx) is None  # no unit yet
    to_host(torch.empty(1, device="meta"))  # before the window: not counted
    with recording():
        for reads in (7, 7):
            with span("eval.batch", unit=True):
                for _ in range(reads):
                    to_host(torch.empty(1, device="meta"))
    assert load_reader("host_reads_per_batch.eval").read(ctx) == 7.0
    assert load_reader("cuda_mallocs_per_batch.eval").read(ctx) == 0.0
    assert load_reader("cuda_mallocs_per_request.serve").read(ctx) == 0.0
    load_s = profiling.counters()["kernel_load_s"]
    assert load_reader("kernel_load_s").read(ctx) == load_s
    profiling.reset_counters()


@pytest.mark.parametrize("modes", [("off", "recorder"), ("profiler",)])
@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_the_tool_runs_each_mode_on_a_tiny_cell(name, modes):
    from bench_port.tools.program_spans import run

    lines = list(run(tiny_cell(name), 2 ** 31 + 11, 0.2, list(modes), device="cpu"))
    assert [x["mode"] for x in lines] == list(modes)
    unit = "eval.batch" if name.endswith("eval128") else "serve.request"
    for x in lines:
        assert x["units"] >= 1 and x["candidates_per_s"] > 0
        if x["mode"] == "recorder":
            assert x["span_ms_a_unit"][unit]["total"] > 0
            assert x["counters"]["units"] == x["units"]
        if x["mode"] == "profiler":
            assert unit in x["idle_ms_a_unit_by_span"] and "aggregate" in \
                x["idle_ms_a_unit_by_span"]
            assert 0 <= x["idle_in_no_program_span_s"] <= x["idle_s"]
            assert x["counters"]["units"] == x["units"]
