"""The paper's protocol lifted to deep-net training, on the PyTorch/CUDA
port: train the same reduced transformer with (a) classical all-reduce DP
and (b) GADGET-style gossip consensus, and compare loss curves + replica
disagreement.

``consensus="gossip"`` turns every optimizer step into local-step + Push-Sum
parameter mixing (point-to-point exchanges on a mesh of processes; a
leading replica axis here, in one process).

The twin of ``examples/gossip_vs_allreduce.py`` on ``repro_torch``: the same
config, schedule, token stream and printed lines. On the CUDA card (the
default) every attention layer runs the ``flash_attention`` kernel forward
and its backward operator; ``--device cpu`` runs the plain PyTorch path.

  PYTHONPATH=src python examples/torch_gossip_vs_allreduce.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.tokens import Batcher, TokenStreamConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import Model

STEPS, BATCH, SEQ, G = 30, 16, 64, 4


def run(consensus: str, gossip_rounds: int = 1, params: dict | None = None, *, device=None):
    """``STEPS`` steps of reduced llama3-8b (2 layers x 128) from the
    generator's draws, or from ``params`` (a ``Model.state_dict``, e.g. the
    reference's initial parameters carried across by ``repro_torch.convert``;
    every gossip replica starts from them). Returns (losses, the replicas'
    largest relative disagreement)."""
    cfg = get_config("llama3-8b").reduced(n_layers=2, d_model=128)
    model = Model(cfg, device=device)
    dev = model.device
    tcfg = steps_mod.TrainerConfig(
        optimizer="adamw", lr=3e-3, total_steps=STEPS, warmup_steps=3,
        consensus=consensus, n_replicas=G if consensus == "gossip" else 1,
        gossip_rounds=gossip_rounds)
    state = steps_mod.make_train_state(model, tcfg, torch.Generator(device=dev).manual_seed(0))
    if params is not None:
        like = state["params"]
        state["params"] = {k: torch.as_tensor(params[k], device=dev).expand_as(v).clone()
                           for k, v in like.items()}
    step_fn = steps_mod.make_train_step(model, tcfg)
    batcher = Batcher(TokenStreamConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
    losses = []
    for s in range(STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batcher.global_batch(s).items()}
        if consensus == "gossip":
            b = {k: v.reshape(G, BATCH // G, SEQ) for k, v in b.items()}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    spread = 0.0
    if consensus == "gossip":
        spreads = []
        for leaf in state["params"].values():
            c = leaf.mean(0, keepdim=True)
            spreads.append(float(torch.linalg.norm((leaf - c).to(torch.float32)))
                           / (float(torch.linalg.norm(c.to(torch.float32))) + 1e-9))
        spread = max(spreads)
    return losses, spread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    l_ar, _ = run("allreduce", device=dev)
    for rounds in (1, 2):
        l_go, spread = run("gossip", rounds, device=dev)
        print(f"gossip R={rounds}: loss {l_go[0]:.3f}->{np.mean(l_go[-5:]):.3f} "
              f"(allreduce {l_ar[0]:.3f}->{np.mean(l_ar[-5:]):.3f}); "
              f"final replica disagreement {spread:.3%}")
    # comm cost note (per step per replica, P = model bytes):
    #   allreduce 2(n-1)/n P ~ 1.9P at n=16 ; gossip R/2 P = 0.5P (R=1)
    print("comm/step: allreduce ~1.9x model bytes; gossip R=1 ~0.5x "
          "(see benchmarks/gossip_comm.py for measured collective bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
