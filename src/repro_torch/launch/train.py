"""Training entry point of the transformer scaffolding: real steps on the card
(or the CPU with ``--device cpu``).

It trains reduced configs end to end. The consensus strategy is selectable:
``--consensus gossip`` turns on the paper's Push-Sum parameter mixing across
``--n-replicas`` divergent replicas (the GADGET protocol applied to deep
nets); the default is classical all-reduce data parallelism. Token models
learn the synthetic Zipf-and-motif stream (``data.tokens``); the VLM and
audio models random embeddings (``launch.input_specs``). The exit code is 0
only if the mean of the last five losses is below the first five's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --reduced \\
      --steps 50 --batch 8 --seq 128 --consensus gossip --n-replicas 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import train_state_to_reference
from repro_torch.data.tokens import Batcher, TokenStreamConfig
from repro_torch.launch import input_specs as ispecs
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import Model

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced (CI-scale) variant")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "sgd"))
    ap.add_argument("--consensus", default="allreduce", choices=("allreduce", "gossip"))
    ap.add_argument("--n-replicas", type=int, default=4)
    ap.add_argument("--gossip-rounds", type=int, default=1)
    ap.add_argument("--mix-every", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", help="save checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-jsonl", help="append step metrics here")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model)
    model = Model(cfg, device=args.device)
    dev = model.device
    gossip = args.consensus == "gossip"
    tcfg = steps_mod.TrainerConfig(
        optimizer=args.optimizer, lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10), consensus=args.consensus,
        n_replicas=args.n_replicas if gossip else 1,
        gossip_rounds=args.gossip_rounds, mix_every=args.mix_every,
        remat=args.remat)

    state = steps_mod.make_train_state(model, tcfg,
                                       torch.Generator(device=dev).manual_seed(args.seed))
    step_fn = steps_mod.make_train_step(model, tcfg)

    print(f"arch={cfg.name} params={sum(v.numel() for v in state['params'].values()):,} "
          f"consensus={args.consensus}"
          + (f" replicas={args.n_replicas} rounds={args.gossip_rounds}" if gossip else ""))

    # structured synthetic stream (Zipf + motifs) for token models so the
    # loss actually has something to learn; random embeddings otherwise
    batcher = None
    if cfg.embed_kind == "tokens":
        batcher = Batcher(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                            global_batch=args.batch, seed=args.seed))

    def get_batch(step: int) -> dict:
        if batcher is None:
            return ispecs.make_host_batch(cfg, args.batch, args.seq, seed=1000 + step,
                                          n_replicas=args.n_replicas if gossip else 0,
                                          device=dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batcher.global_batch(step).items()}
        if gossip:
            G = args.n_replicas
            b = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:]) for k, v in b.items()}
        return b

    def save(step: int) -> None:
        ckpt.save(args.ckpt_dir, step, train_state_to_reference(cfg, tcfg, state))

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, get_batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({time.time()-t0:.1f}s)")
        if args.log_jsonl:
            with open(args.log_jsonl, "a") as fh:
                fh.write(json.dumps({"step": step, "loss": loss,
                                     "t": time.time() - t0}) + "\n")
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)

    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.ckpt_dir:
        save(args.steps)
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
