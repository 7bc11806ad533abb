"""Serving entry point for the *transformer* architectures: prefill a batch of
requests, then decode tokens greedily.

This is the token-decode surface of the seed scaffolding, not the SVM
serving path (``repro_torch.serve``). It runs a reduced config by default;
the model runs on the CUDA device unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import Model

__all__ = ["prefill_into_cache", "greedy_generate", "main"]


def prefill_into_cache(model: Model, tokens: torch.Tensor, cache, step_fn):
    """Feed the prompt one token at a time (simple, reuses serve_step; a
    production prefill would batch this, as ``make_prefill_step`` does)."""
    B, S = tokens.shape
    logits = None
    for t in range(S):
        logits, cache = step_fn(tokens[:, t:t + 1], cache, t)
    return logits, cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model: Model, prompt: torch.Tensor, n_gen: int, step_fn,
                    cache_dtype: torch.dtype = torch.float32) -> dict:
    """Prefill ``prompt`` (B, S) into a fresh cache, then decode ``n_gen``
    tokens greedily. Returns ``{"tokens" (B, n_gen), "prefill_s",
    "decode_s"}``, the times on the host clock, each ending in a device sync."""
    B, S = prompt.shape
    cache = model.init_cache(B, S + n_gen, cache_dtype)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(model, prompt, cache, step_fn)
    _sync(prompt.device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    t0 = time.perf_counter()
    for i in range(n_gen):
        out_tokens.append(tok)
        logits, cache = step_fn(tok, cache, S + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(prompt.device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(n_layers=args.layers, d_model=args.d_model)
    if not cfg.supports_decode():
        print(f"{cfg.name} is encoder-only: no decode path")
        return 0
    model = Model(cfg, device=args.device)
    dev = model.device
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    step_fn = steps_mod.make_serve_step(model)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
                           device=dev)
    out = greedy_generate(model, prompt, args.gen, step_fn)
    gen = out["tokens"]

    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={dev}")
    print(f"prefill {out['prefill_s'] * 1e3:.1f}ms  "
          f"decode {out['decode_s'] * 1e3 / max(1, args.gen):.2f}ms/tok")
    print("sample row 0:", gen[0].tolist())
    if not bool(torch.all((gen >= 0) & (gen < cfg.vocab_size))):
        raise RuntimeError("generated a token outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
