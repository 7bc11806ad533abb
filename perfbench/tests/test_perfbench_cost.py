"""The frozen yardstick: the least work of an iteration and its layers
against hand counts."""
from __future__ import annotations

import torch

from perfbench.cost import iteration as work


def test_half_step_hand_count():
    # dense: 2 nodes x 3 rows x 5 floats, 6 labels, W read and written
    assert work.half_step(2, 3, 5, None) == {"bytes": 4 * (30 + 6 + 20),
                                             "flops": 4 * 30 + 6 + 6 * 10}
    # ELL: 2 nodes x 3 rows x 4 entries of a column and a value
    assert work.half_step(2, 3, 5, 4) == {"bytes": 4 * (2 * 24 + 6 + 20),
                                          "flops": 4 * 24 + 6 + 6 * 10}


def test_projection_hand_count():
    # 2 nodes x 5 floats read and written; a square-add and a multiply an entry
    assert work.projection(2, 5) == {"bytes": 4 * (10 + 10), "flops": 3 * 10}
    # at kdda's fleet, one read and one write of 10 x 20,216,830 floats
    assert work.projection(10, 20_216_830)["bytes"] == 2 * 4 * 202_168_300


def test_mix_and_iteration_hand_count():
    assert work.mix(4, 10, 7) == {"bytes": 4 * (80 + 8 + 7), "flops": 2 * 7 * 11}
    it = work.iteration(2, 3, 5, 4, 7)
    assert it["bytes"] == 4 * (4 * 10 + 2 * 24 + 6 + 7)
    assert it["flops"] == 4 * 24 + 6 + 6 * 10 + 2 * 7 * 6 + 10 + 30 + 10


def _rounds(targets, m):
    eye = torch.eye(m)
    return torch.stack([0.5 * eye + 0.5 * torch.nn.functional.one_hot(
        torch.tensor(t), m).float() for t in targets])[None]


def test_mix_nnz_of_a_collapsed_random_neighbour_product():
    # 4 nodes; round 1: 0->1, 1->2, 2->3, 3->0; round 2: 0->2, 1->3, 2->0, 3->1.
    # After two rounds node j holds mass from j, j-1, j-2, j-3: every entry.
    assert work.mix_nnz(_rounds([[1, 2, 3, 0], [2, 3, 0, 1]], 4)) == 16
    # round 2 pushes back along round 1's links: node j keeps {j, j-1} and
    # receives {j+1, j} from node j+1, three sources a node
    assert work.mix_nnz(_rounds([[1, 2, 3, 0], [3, 0, 1, 2]], 4)) == 12
    # one round: the diagonal and one target a node
    assert work.mix_nnz(_rounds([[1, 0, 3, 2]], 4)) == 8


def test_least_seconds_takes_the_bound_that_binds():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert peak["hbm_bytes_per_s"] == 3.35e12 and peak["f32_flops_per_s"] == 67e12
    assert work.least_seconds({"bytes": 3.35e12, "flops": 1.0}, peak) == 1.0
    assert work.least_seconds({"bytes": 1.0, "flops": 134e12}, peak) == 2.0
    assert work.peaks("cpu") is None


def test_layer_table_and_spans():
    from repro_torch.core import gadget
    from repro_torch.kernels.hinge_subgrad import ops

    from perfbench import trace
    assert trace.layer_of("void fleet_half_step_kernel<true>(float const*)", "") == "half_step"
    assert trace.layer_of("void at::native::index_elementwise_kernel<128, 4>", "step") == "gather"
    assert trace.layer_of("void at::native::index_elementwise_kernel<128, 4>", "draws") == "draws"
    assert trace.layer_of("sm80_xmma_gemm_f32f32", "") == "other"
    before = (gadget._Run.chunk, gadget.mix_collapsed, ops.fleet_half_step,
              gadget.GeneratorDraws.take)
    with trace.spans():
        during = (gadget._Run.chunk, gadget.mix_collapsed, ops.fleet_half_step,
                  gadget.GeneratorDraws.take)
        assert all(a is not b and b.__wrapped__ is a for a, b in zip(before, during))
    assert (gadget._Run.chunk, gadget.mix_collapsed, ops.fleet_half_step,
            gadget.GeneratorDraws.take) == before
