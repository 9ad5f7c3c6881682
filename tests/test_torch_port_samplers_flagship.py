"""The agents' sampler tests of tests/test_torch_port_samplers.py at
tiny_flagship_config (dino='pointwise': DINOv3 ViT, ImgEncoder, Fus
PointNet++), in a file of their own so that each file stays short under
``--dist loadfile``. Tolerances are stated at each assert there."""

import pytest

import test_torch_port_samplers as base
from test_torch_port_samplers import one_thread  # noqa: F401
from test_torch_port_samplers import (test_calc_likelihood_matches_jax,  # noqa: F401
                                      test_edm_sampler_matches_jax,
                                      test_evaluator_rk45_mode_matches_jax,
                                      test_ode_sampler_euler_and_trajectory_match_jax,
                                      test_pc_sampler_matches_jax,
                                      test_rk45_score_net_matches_jax,
                                      test_sample_candidates_matches_jax)


@pytest.fixture(scope="module")
def agents():
    return base.make_agents("tiny_flagship_config")
