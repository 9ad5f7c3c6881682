"""FLOP and byte counts against hand counts at tiny shapes."""

import pytest
import torch

from bench_port.harness.costs import (PEAK, HBM_BYTES_PER_S, ProductFlops, least_seconds,
                                      rk4_cost, sa_stage_cost)


def test_product_flops_by_kind():
    a, b = torch.randn(4, 6), torch.randn(6, 5)
    with ProductFlops() as c:
        a @ b
        torch.bmm(torch.randn(3, 4, 6), torch.randn(3, 6, 2))
        a.bfloat16() @ b.bfloat16()
        torch.relu(a)  # no product
    assert c.flops["float32"] == 2 * 4 * 6 * 5 + 3 * 2 * 4 * 6 * 2
    assert c.flops["bfloat16"] == 2 * 4 * 6 * 5


def test_product_flops_of_a_linear_layer():
    lin = torch.nn.Linear(7, 3)
    with ProductFlops() as c:
        lin(torch.randn(5, 7))
    assert c.flops["float32"] == 2 * 5 * 7 * 3


def test_rk4_cost_by_hand():
    D, P1, P2, H1, rows, steps = 9, 4, 5, 6, 10, 3
    macs = 9 * 4 + 4 * 5 + 5 * 6 + 6 * 9
    nbytes, ops = rk4_cost(D, P1, P2, H1, rows, steps, "float32")
    assert nbytes == 10 * 9 * 8 + 10 * 6 * 4 + macs * 4 + 3 * (3 * 6 + 7) * 4
    assert ops == {"float32": 3 * 4 * 10 * 2 * macs}
    nb16, ops16 = rk4_cost(D, P1, P2, H1, rows, steps, "bfloat16")
    assert nbytes - nb16 == macs * 2 and ops16 == {"bfloat16": ops["float32"]}


def test_sa_stage_cost_by_hand():
    B, N, M = 2, 16, 4
    scale = {"h1": 3, "weights": [(3, 5), (5, 7)], "affine_values": 3 + 5 + 7, "c_out": 7,
             "rows": 20}
    nbytes, ops = sa_stage_cost(B, N, M, [scale], "float32")
    macs = 3 * 5 + 5 * 7
    assert nbytes == (12 * 2 * (16 + 4) + 2 * 16 * 3 * 4 + 2 * 4 * 3 * 4 + macs * 4
                      + 2 * 4 * 15 + 2 * 4 * 7 * 4)
    assert ops == {"float32_other": 9 * 2 * 4 * 16 + 20 * 4 * 3, "float32": 20 * 2 * macs}


def test_least_seconds_is_the_larger_bound():
    assert least_seconds(HBM_BYTES_PER_S, {}) == pytest.approx(1.0)
    assert least_seconds(0, {"bfloat16": PEAK["bfloat16"], "float32": PEAK["float32"]}) == \
        pytest.approx(2.0)
    assert PEAK == {"bfloat16": 989e12, "float32": 495e12, "float32_other": 67e12}
