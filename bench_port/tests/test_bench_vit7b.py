"""The DINOv3 ViT-7B/16 configuration and its cell on the CPU, at the tiny
size of ``bench_port/conftest.py`` (the 7B entry at width 256, two blocks):
its configuration file in both packages, its frozen reference's imports,
the weights both sides draw from a seed, the chunked draw, the ViT kernels'
costs, its driver's ``correct`` under faults, and its readers on an
untraced run."""

import json
import math

import pytest
import torch

from bench_port.harness import agents, chunked_weights, configs, vit_costs
from bench_port.harness.manifest import BENCH_DIR, find_cell, load_driver, load_reader
from bench_port.harness.runner import Context, run_cell
from bench_port.harness.trace import Spans
from bench_port.tests.helpers import tiny_cell
from bench_port.tests.test_bench_imports import _python

CELL = "dinov3_vit7b.eval128"
REF = "bench_port.reference_vit7b"
SPEC = json.loads((BENCH_DIR / "configs" / "dinov3_vit7b.json").read_text())


@pytest.mark.parametrize("package", [agents.PORT, REF])
def test_the_configuration_builds_as_its_file_holds_it(package):
    cfg = agents.config(package, SPEC)
    assert configs.as_json(cfg) == SPEC["config"]
    m = cfg.model
    assert (m.backbone, m.dino_dim, m.backbone_depth, tuple(m.dino_layer_ids)) == \
        ("dinov3_vit7b16", 4096, 40, (9, 22, 39))
    assert SPEC["reduced"] == [] and set(SPEC["assumed"]) == {"taps", "weights", "layernorm_eps"}


def test_the_cell_keeps_flagships_traffic():
    ours, theirs = find_cell(BENCH_DIR.parent, CELL), find_cell(BENCH_DIR.parent,
                                                               "flagship.eval128")
    keys = ("objects", "pool", "shapes", "judge_units")
    assert {k: ours.traffic[k] for k in keys} == {k: theirs.traffic[k] for k in keys}
    drop = ("model.backbone", "model.dino_dim", "model.backbone_depth", "model.dino_layer_ids")

    def rest(c):
        flat = configs.as_json(agents.config(agents.PORT, c))
        return {k: v for k, v in flat.items() if k != "model"}, \
            {k: v for k, v in flat["model"].items() if f"model.{k}" not in drop}
    assert rest(ours.config) == rest(theirs.config)
    assert set(ours.traffic["reference"]) == {"package", "backbone_gap"}
    assert ours.traffic["reference"]["package"] == REF


def test_the_frozen_copy_loads_nothing_of_the_port_or_jax():
    got = _python(
        "import json, sys, pkgutil, importlib\n"
        "import bench_port.reference_vit7b as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'bench_port.reference_vit7b.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    assert not {"genpose2_tpu_torch", "genpose2_tpu", "jax", "jaxlib", "flax"} & set(got)
    sources = json.loads((BENCH_DIR / "reference_vit7b" / "SOURCES.json").read_text())
    assert sources["models/backbones.py"]["source"] == "genpose2_tpu_torch/models/backbones.py"
    assert sources["utils/profiling.py"]["stand_in"] == "no spans, no counters"


def test_both_sides_build_the_same_weights_from_a_seed():
    spec = tiny_cell(CELL).config
    sides = [chunked_weights.build(p, spec, 2 ** 31 + 5, "cpu") for p in (agents.PORT, REF)]
    mods = [agents.modules_of(s, e, sc) for _, s, e, sc in sides]
    for a, b in zip(*mods):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    vit = sides[0][1].provider.vit
    assert vit.blocks[0].attn.qkv.bias is None and vit.num_heads == 2
    assert vit.blocks[0].mlp.w1.weight.dtype == torch.bfloat16


def test_the_chunked_draw_moves_every_leaf_from_the_seed():
    def made(seed, chunk):
        torch.manual_seed(0)
        mods = [torch.nn.Linear(7, 5), torch.nn.BatchNorm1d(3), torch.nn.Linear(5, 2)]
        n = chunked_weights.randomize_chunked(mods, seed, "cpu", chunk=4)
        return n, [t.detach().clone() for m in mods for t in m.state_dict().values()]

    torch.manual_seed(0)
    start = [t.clone() for m in (torch.nn.Linear(7, 5), torch.nn.BatchNorm1d(3),
                                 torch.nn.Linear(5, 2)) for t in m.state_dict().values()]
    n, a = made(3, 4)
    assert n == 7 * 5 + 5 + 3 + 3 + 5 * 2 + 2 + 3 + 3  # parameters, means, variances
    assert all(torch.equal(x, y) for x, y in zip(a, made(3, 4)[1]))
    moved = [not torch.equal(x, y) for x, y in zip(a, start)]
    assert moved == [True, True, True, True, True, True, False, True, True]  # not the count
    assert not torch.equal(a[0], made(4, 4)[1][0])


def test_vit_kernel_costs_at_the_cells_shape():
    nbytes, ops = vit_costs.vit_attention_cost(128, 272, 4096, 32, 261, "bfloat16")
    assert nbytes == 128 * 261 * 4096 * 10
    assert ops == {"bfloat16": 4 * 128 * 32 * 261 ** 2 * 128,
                   "float32_other": 5 * 128 * 32 * 261 ** 2}
    nbytes, ops = vit_costs.add_layernorm_cost(128 * 272, 4096, "bfloat16")
    assert nbytes == 4 * 128 * 272 * 4096 * 2 + 3 * 4096 * 4
    assert ops == {"float32_other": 8 * 128 * 272 * 4096}


def test_a_traced_judge_counts_the_vit_kernels():
    cell = tiny_cell(CELL)
    driver = load_driver(cell.traffic["driver"])
    ctx = Context(cell, 2 ** 31 + 7, 0.0, True, "cpu", Spans(False))
    driver.reference(ctx, [0, 1])
    c = ctx.costs
    # one unit counted: two blocks, one attention and one add-LayerNorm each
    assert c["vit_attention.launches"] == 2 and c["add_layernorm.launches"] == 2
    assert c["vit_attention.bound_s"] > 0 and c["add_layernorm.bound_s"] > 0
    assert c["flops.bfloat16"] > 0 and c["flops.float32"] > 0
    assert "rk4.bound_s" in c
    # the frozen copy's SA stages, which reference_run.costed does not reach
    assert c["sa_stage.launches"] == 4 and c["sa_stage.bound_s"] > 0


def test_the_reference_is_held_to_the_plain_dinov3(monkeypatch):
    """Each judged unit holds the frozen copy's backbone to ``dinov3_plain``
    on the same crops and weights: a few bf16 steps apart at the tiny size,
    and a semantic error in the frozen copy (its products' signs flipped,
    the patch embedding's too) stops the judge."""
    from bench_port.reference_vit7b.models import vit as frozen_vit

    cell = tiny_cell(CELL)
    driver = load_driver(cell.traffic["driver"])
    ctx = Context(cell, 2 ** 31 + 11, 0.0, False, "cpu", Spans(False))
    cfg, s, _, _ = chunked_weights.build(REF, cell.config, ctx.seed, "cpu")
    pool, _ = load_driver("eval_streaming")._inputs(ctx, cfg)
    rgb = pool[0]["roi_rgb"]
    feats = torch.stack(s.provider.patch_features(rgb, plain=True))
    g = driver.backbone_gap(REF, cfg, s.provider, rgb, feats)
    assert 0 < g < 0.02  # the tiny ViT's two blocks in bf16, as test_torch_port_vit7b.py
    assert driver.backbone_gap(REF, cfg, s.provider, rgb, feats * 1.2) > 0.1
    mm = frozen_vit.mm
    monkeypatch.setattr(frozen_vit, "mm", lambda a, w, dt: -mm(a, w, dt))
    with pytest.raises(RuntimeError, match="strays from the plain DINOv3"):
        driver.reference(ctx, [0])


@pytest.mark.parametrize("fault", ["candidate_altered", "energy_altered", "features_altered"])
def test_the_cells_judge_reads_a_fault_as_incorrect(fault, monkeypatch):
    from bench_port.tests.test_bench_faults import FAULTS
    from genpose2_tpu_torch.training.agent import PoseAgent

    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(PoseAgent, attr, wrap(getattr(PoseAgent, attr)))
    r = run_cell(tiny_cell(CELL), 2 ** 31 + 43, 0.3, False, "cpu")
    assert not r["correct"], r["checks"]


def test_the_cells_readers_read_nothing_without_a_trace():
    cell = find_cell(BENCH_DIR.parent, CELL)
    ctx = Context(cell, 1, 0.0, False, "cpu", Spans(False))
    for m in cell.per_layer:
        assert load_reader(m["name"]).read(ctx) is None, m["name"]
    assert {m["name"] for m in cell.per_layer} == {
        "rk4_roofline.eval", "sa_stage_roofline.eval", "mfu_pct.eval", "device_idle_pct.eval",
        "kernel_launches_per_batch.eval", "host_reads_per_batch.eval",
        "cuda_mallocs_per_batch.eval", "kernel_load_s", "vit_attention_roofline.vit7b",
        "add_layernorm_roofline.vit7b", "backbone_weight_gb.vit7b"}
    assert all(math.isfinite(v) and v >= 0 for v in cell.traffic["limits"].values())
