"""The plain reference agrees with the program at tiny sizes: its draws bit
for bit, and whole runs of every cell's path (dense and ELL), and of the minibatches,
link faults, message mode, dead node and exponential graph a later mix may
state, to float32 rounding."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import reference as ref
from perfbench import run, spec, threefry

TRAFFIC = {w["name"]: w["traffic"] for w in json.loads(
    (spec.HERE.parent / "BENCHMARK.json").read_text())["workloads"]}
CELLS = list(TRAFFIC)


def test_threefry_is_the_programs():
    from repro_torch.core import counter_rng as crng
    key = crng.fold_in(crng.prng_key(2 ** 31 - 5), 7)
    idx = torch.arange(1000, dtype=torch.int64)
    assert torch.equal(threefry.bits(key, idx), crng.random_bits(key, idx))
    span = torch.randint(1, 3000, (1000,))
    assert torch.equal(threefry.randint(key, idx, span), crng.randint(key, idx, span))
    assert torch.equal(threefry.bernoulli(key, idx, 0.1), crng.bernoulli(key, idx, 0.1))


@pytest.mark.parametrize("topology", ["random", "exponential"])
@pytest.mark.parametrize("faults", [None, {"drop_prob": 0.3, "drop": "link", "dead_nodes": (),
                                          "seed": 4},
                                    {"drop_prob": 0.3, "drop": "message", "dead_nodes": (2,),
                                     "seed": 9}])
def test_draws_are_the_programs(topology, faults):
    from repro_torch.core import faults as flt
    from repro_torch.core.gadget import DrawPlan, GeneratorDraws
    from repro_torch.core.push_sum import collapse_rounds
    m, B, R, t0, n = 6, 5, 3, 41, 7
    counts = torch.tensor([9, 8, 9, 7, 9, 9])
    s = ref.Settings(1e-4, B, R, topology, 123, faults)
    plan = None if faults is None else flt.FaultPlan(faults["drop_prob"], faults["drop"],
                                                     faults["dead_nodes"], faults["seed"])
    dp = DrawPlan(m, B, R, topology, True, counts, plan)
    gd = GeneratorDraws(123)
    ids, mix = gd.take(t0, n, dp)
    mine = ref.Draws(s, counts)
    assert torch.equal(mine.ids(t0, n), ids)
    if topology == "exponential":
        from repro_torch.core import topology as topo
        stack = torch.from_numpy(topo.build_matrix_stack("exponential", m))
        g = (torch.arange(n)[:, None] + t0 - 1) * R + torch.arange(R)
        mix = stack[g % stack.shape[0]]
    elif plan is None:
        assert torch.equal(collapse_rounds(mine.rounds(t0, n)), mix)
        return
    if plan is not None:
        mix = flt.apply_faults(mix, gd.fails(t0, n, dp), plan)
    assert torch.equal(mine.rounds(t0, n), mix)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program(small, cell):
    c = spec.load(cell, small)
    result = run.measure(c, 2 ** 31 + 77, 0.3, False, torch.device("cpu"))
    assert result["correct"]
    assert all(v["value"] < 1e-5 for v in result["checks"].values()), result["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("extra", [
    {"topology": "exponential"},
    {"batch_size": 16},
    {"batch_size": 4, "faults": {"drop_prob": 0.1, "drop": "link"}},
    {"faults": {"drop_prob": 0.2, "drop": "message", "dead_nodes": [3]}},
], ids=["exponential", "minibatch", "link_faults", "message_faults_dead_node"])
def test_reference_follows_the_program_on_other_mixes(small, cell, extra):
    f = small / f"perfbench/traffic/{TRAFFIC[cell]}.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), **extra}))
    result = run.measure(spec.load(cell, small), 3, 0.3, False, torch.device("cpu"))
    assert result["correct"] and max(v["value"] for v in result["checks"].values()) < 1e-5


def test_tf32_rounds_the_mantissa_to_ten_bits_nearest_even():
    one, ulp = 1.0, 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, one + ulp / 2 + 2.0 ** -20,
                      -(one + 1.5 * ulp), 3.0, one + ulp / 4], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * ulp, one + ulp, -(one + 2 * ulp), 3.0, one])
    assert torch.equal(ref.tf32(x), want)
