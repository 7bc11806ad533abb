"""The port's gossip-mode train step (every parameter with a leading axis
of G = 4 replicas, local steps, Push-Sum mixing) against the reference's
jitted step for 3 fixed steps on the same state and batches: dense, MoE,
RG-LRU and RWKV-6 blocks, both optimizers, ``mix_every=2``, two rounds,
the bf16 payload and remat ("full" and "dots"); held as
``tests/test_torch_train.py`` says. The patches and frames layouts are held to
the reference in ``test_torch_train.py`` (all-reduce); in gossip mode
frames train through the CLI there, and both on the card against the CPU
in ``chip_smoke.py`` phase 23."""
import pytest

pytest.importorskip("torch")

from tests.test_torch_train import assert_states_close, run_pair, trainer  # noqa: E402

CASES = [  # arch, layers, optimizer, options
    ("llama3-8b", 1, "adamw", dict(mix_every=2, gossip_rounds=2)),
    ("qwen2-moe-a2.7b", 1, "sgd", dict(gossip_payload="bf16")),
    ("recurrentgemma-9b", 3, "sgd", dict(remat=True)),
    # rwkv6 under gossip AdamW at lr 3e-3 leaves the reference's trajectory
    # after two steps (its first step's AdamW outliers, 22 of 595,712
    # elements, change the next gradients); under SGD it holds at ATOL
    ("rwkv6-3b", 1, "sgd", dict(remat=True, remat_policy="dots")),
]


@pytest.mark.parametrize("arch,n_layers,optimizer,options", CASES,
                         ids=[c[0] for c in CASES])
def test_gossip_step_matches_reference(arch, n_layers, optimizer, options):
    want, got, tcfg, _, losses = run_pair(arch, n_layers, **trainer("gossip", optimizer,
                                                                     **options))
    for ref_loss, port_loss in losses:
        assert abs(ref_loss - port_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    assert_states_close(want, got, tcfg)
