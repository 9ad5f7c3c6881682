"""A run with the timed path broken underneath reads ``correct`` false, at
each cell's own limits: the chip check is skipped (CPU, tiny sizes), the
rest of the run is the run's. The faults a cell that serves or evaluates
can have: an answer altered where it is produced (a candidate, an energy,
the backbone's output) and half of the batch left out (its answers taken
from the other half)."""

import pytest
import torch

from bench_port.harness.runner import run_cell
from bench_port.tests.helpers import manifest, tiny_cell

CELLS = [w["name"] for w in manifest()["workloads"]]


def _has_backbone(name: str) -> bool:
    from bench_port.harness import agents

    return agents.config(agents.PORT, tiny_cell(name).config).model.dino == "pointwise"


def _candidate_altered(orig):
    def sample(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        out[0, 0, -1] += 0.05  # one candidate's depth off by 5 cm
        return out
    return sample


def _half_answers(orig):
    def sample(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]
        return out
    return sample


def _energy_altered(orig):
    def energy(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        out[0, 0] *= 1.5
        return out
    return energy


def _features_altered(orig):
    def with_image_features(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if "dino_layers" in out:
            layers = [t.clone() for t in out["dino_layers"]]
            layers[0][0, 0, 0] += 0.05 * float(layers[0].abs().max())
            out = dict(out, dino_layers=layers)
        return out
    return with_image_features


FAULTS = {"candidate_altered": ("sample_candidates", _candidate_altered),
          "half_left_out": ("sample_candidates", _half_answers),
          "energy_altered": ("get_energy", _energy_altered),
          "features_altered": ("with_image_features", _features_altered)}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "features_altered" or _has_backbone(c)]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_program_reads_incorrect(name, fault, monkeypatch):
    from genpose2_tpu_torch.training.agent import PoseAgent

    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(PoseAgent, attr, wrap(getattr(PoseAgent, attr)))
    r = run_cell(tiny_cell(name), 2 ** 31 + 41, 0.3, False, "cpu")  # the cell's own limits
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_reads_correct_at_the_cells_limits(name):
    r = run_cell(tiny_cell(name), 2 ** 31 + 41, 0.3, False, "cpu")
    assert r["correct"], r["checks"]
