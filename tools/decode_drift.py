"""Decode against forward, by depth, at a model's full width, on the CPU.

For each depth, draws random weights for ``get_config(arch)`` cut to that
many layers (widths untouched), runs the full-sequence forward over a
prompt and then the one-token decode step over the same tokens, and prints
the largest |decode − forward| over the logits and its excess over the
relative part of ``tests/test_decode_consistency.py``'s tolerance
(5e-4 abs + 1e-3 rel). It runs the JAX reference (``--impl jax``, its own
``jax.random`` weights) or the port (``--impl torch``, a seeded
``torch.Generator``): with random weights, the f32 rounding that separates
the two paths of one implementation grows with depth, and this shows by how
much in each. With ``--device cuda`` the port runs on the card, and the same
weights run once more on the CPU: the line then also holds the CPU's drift
and the largest gap between the card's forward and the CPU's.

Usage:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/decode_drift.py rwkv6-3b \\
        --impl jax --layers 1 2 4 8 --tokens 16 --seeds 0 1
    PYTHONPATH=src python tools/decode_drift.py rwkv6-3b --impl torch \\
        --device cuda --layers 4 --tokens 64 --batch 2 --seeds 0 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

RTOL = 1e-3


def drift_jax(cfg, tokens: np.ndarray, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.models.transformer import Model

    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    toks = jnp.asarray(tokens)
    full, _ = jax.jit(model.forward)(params, {"tokens": toks})
    full = np.asarray(full)
    cache = model.init_cache(*tokens.shape, jnp.float32)
    step = jax.jit(model.decode_step)
    worst = excess = 0.0
    for t in range(tokens.shape[1]):
        logits, cache = step(params, toks[:, t:t + 1], cache, jnp.int32(t))
        diff = np.abs(np.asarray(logits[:, 0]) - full[:, t])
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - RTOL * np.abs(full[:, t])).max()))
    return {"max_abs_err": worst, "excess_over_rtol": excess}


def _torch_drift(model, toks):
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    full = make_prefill_step(model)({"tokens": toks})
    cache = model.init_cache(*toks.shape, torch.float32)
    step = make_serve_step(model)
    worst = excess = 0.0
    for t in range(toks.shape[1]):
        logits, cache = step(toks[:, t:t + 1], cache, t)
        diff = (logits[:, 0] - full[:, t]).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - RTOL * full[:, t].abs()).max()))
    return worst, excess, full


def drift_torch(cfg, tokens: np.ndarray, seed: int, device: str = "cpu") -> dict:
    import torch

    from repro_torch.models.transformer import Model

    dev = torch.device(device)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    toks = torch.from_numpy(tokens).to(dev)
    worst, excess, full = _torch_drift(model, toks)
    out = {"max_abs_err": worst, "excess_over_rtol": excess}
    if dev.type != "cpu":  # the same weights on the CPU
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        del model
        worst_c, excess_c, full_c = _torch_drift(cpu, toks.cpu())
        out.update(cpu_max_abs_err=worst_c, cpu_excess_over_rtol=excess_c,
                   card_vs_cpu_forward=float((full.cpu() - full_c).abs().max()))
    return out


def main() -> None:
    """Parse the arguments and print one JSON line per depth."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("--impl", choices=("jax", "torch"), default="jax")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0], help="weight seeds")
    ap.add_argument("--device", default="cpu", help="the port's device (--impl torch)")
    args = ap.parse_args()
    if args.impl == "jax":
        from repro.configs import get_config
        drift = drift_jax
    else:
        from repro_torch.configs import get_config

        def drift(cfg, tokens, seed):
            return drift_torch(cfg, tokens, seed, args.device)
    base = get_config(args.arch)
    tokens = np.random.default_rng(1).integers(0, base.vocab_size, (args.batch, args.tokens))
    for n_layers in args.layers:
        cfg = dataclasses.replace(base, n_layers=n_layers)
        for seed in args.seeds:
            print(json.dumps({"arch": args.arch, "impl": args.impl, "layers": n_layers,
                              "d_model": cfg.d_model, "tokens": args.tokens,
                              "batch": args.batch, "seed": seed,
                              **drift(cfg, tokens, seed)}), flush=True)


if __name__ == "__main__":
    main()
