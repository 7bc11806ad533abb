"""End-to-end trainer on the PyTorch/CUDA port: train a ~100M-parameter
llama3-family model for a few hundred steps on the synthetic token stream,
with checkpointing and both consensus strategies available.

The twin of ``examples/train_100m.py`` on ``repro_torch``: the same config,
flags, optimizer, token stream and printed lines. On the CUDA card (the
default) every layer of every step runs the ``flash_attention`` kernel
forward at (batch, 256, 8, 64) and its backward operator, under remat;
``--device cpu`` runs the plain PyTorch path (slow but real). The
checkpoint is the whole train state in the reference's layout
(``repro_torch.convert.train_state_to_reference``), so either package
restores it.

  PYTHONPATH=src python examples/torch_train_100m.py --steps 300
  PYTHONPATH=src python examples/torch_train_100m.py --steps 300 --consensus gossip
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.convert import train_state_to_reference
from repro_torch.data.tokens import Batcher, TokenStreamConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import Model


def build_100m():
    """llama3 family, ~100M params: 8L x 512d x 8H, vocab 32k."""
    base = get_config("llama3-8b")
    return dataclasses.replace(
        base, name="llama3-100m", n_layers=8, d_model=512, d_ff=2048,
        n_heads=8, n_kv_heads=4, head_dim=64, vocab_size=32000)


def trainer_config(steps: int, consensus: str, replicas: int) -> steps_mod.TrainerConfig:
    """AdamW at lr 1e-3, 20 warm-up steps, remat on, one gossip round."""
    gossip = consensus == "gossip"
    return steps_mod.TrainerConfig(
        optimizer="adamw", lr=1e-3, warmup_steps=20, total_steps=steps,
        consensus=consensus, n_replicas=replicas if gossip else 1,
        gossip_rounds=1, remat=True)


def init_state(model: Model, tcfg: steps_mod.TrainerConfig) -> dict:
    """The train state, its weights drawn from seed 0 on the model's device."""
    return steps_mod.make_train_state(model, tcfg,
                                      torch.Generator(device=model.device).manual_seed(0))


def train(model: Model, tcfg: steps_mod.TrainerConfig, state: dict, *, steps: int,
          batch: int, seq: int):
    """``steps`` steps from ``state`` on the token stream's batches, reshaped
    to (G, batch/G, seq) under gossip; prints the loss every 25 steps with
    tokens/s. Returns (state, losses)."""
    cfg, dev = model.cfg, model.device
    gossip = tcfg.consensus == "gossip"
    step_fn = steps_mod.make_train_step(model, tcfg)
    batcher = Batcher(TokenStreamConfig(cfg.vocab_size, seq, batch, seed=0))
    losses, t0 = [], time.time()
    for s in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batcher.global_batch(s).items()}
        if gossip:
            G = tcfg.n_replicas
            b = {k: v.reshape(G, batch // G, seq) for k, v in b.items()}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        if s % 25 == 0 or s == steps - 1:
            tok_s = batch * seq * (s + 1) / (time.time() - t0)
            print(f"step {s:4d} loss {losses[-1]:.4f} ({tok_s:,.0f} tok/s)")
    return state, losses


def save_checkpoint(ckpt_dir: str, step: int, cfg, tcfg: steps_mod.TrainerConfig,
                    state: dict) -> str:
    """The whole train state at ``step``, in the reference's layout."""
    return ckpt.save(ckpt_dir, step, train_state_to_reference(cfg, tcfg, state))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--consensus", default="allreduce", choices=("allreduce", "gossip"))
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_100m()
    gossip = args.consensus == "gossip"
    tcfg = trainer_config(args.steps, args.consensus, args.replicas)
    model = Model(cfg, device=dev)
    state = init_state(model, tcfg)
    n_params = sum(v.numel() for v in state["params"].values())
    n_params //= args.replicas if gossip else 1
    print(f"model={cfg.name} params={n_params/1e6:.1f}M consensus={args.consensus}")

    state, losses = train(model, tcfg, state, steps=args.steps, batch=args.batch,
                          seq=args.seq)
    save_checkpoint(args.ckpt_dir, args.steps, cfg, tcfg, state)
    print(f"checkpoint -> {args.ckpt_dir}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'IMPROVED' if last < first - 0.2 else 'check hyperparams'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
