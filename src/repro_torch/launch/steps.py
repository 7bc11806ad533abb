"""Train / serve step factories: the paper's consensus strategies wired into
transformer training, and the serve-side steps.

Two training modes (``TrainerConfig.consensus``), as in the reference:

* ``allreduce``: a single copy of the weights; the value and gradient of
  ``model.loss`` over the whole batch, clipped by the global norm, one
  optimizer update. The deep-net analogue of the paper's centralised Pegasos.
* ``gossip``: every parameter leaf gains a leading replica axis of size
  ``n_replicas``; each replica computes its *local* gradient on its batch
  slice, is clipped by its own global norm and takes its own optimizer
  step, and the replicas are then mixed with Push-Sum rounds
  (``core.consensus.gossip_mix_stacked``). GADGET SVM lifted to any model.

State layout: ``{"params": {name: tensor}, "opt": optimizer state, "step":
int32 tensor}``, the names the model's ``state_dict`` keys. The ``Model``
provides the structure; a step swaps the state's tensors in for its
parameters (:func:`swapped_params`) for the forward and the backward, so
the model's own parameters are not trained. Load ``state["params"]`` into
it to serve the trained weights. The serve steps (prefill, decode) run
without autograd.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.core.consensus import gossip_mix_stacked
from repro_torch.models.transformer import Model

Pytree = Any

__all__ = ["TrainerConfig", "make_train_state", "make_train_step", "make_serve_step",
           "make_prefill_step", "swapped_params"]


@dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "adamw"        # adamw | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    consensus: str = "allreduce"    # allreduce | gossip
    n_replicas: int = 1             # gossip replicas
    gossip_rounds: int = 1          # Push-Sum rounds per step
    gossip_self_share: float = 0.5
    mix_every: int = 1
    remat: bool = False
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    gossip_payload: str = "full"    # full | bf16 (quantized gossip shares)


def _make_opt(tcfg: TrainerConfig) -> optim.GradientTransformation:
    sched = optim.cosine_warmup(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    if tcfg.optimizer == "adamw":
        return optim.adamw(sched, weight_decay=tcfg.weight_decay)
    if tcfg.optimizer == "sgd":
        return optim.sgd(sched, momentum=0.9)
    raise ValueError(tcfg.optimizer)


def make_train_state(model: Model, tcfg: TrainerConfig, gen: torch.Generator | None) -> dict:
    """Draw the model's weights from ``gen`` (``model.init``) and build the
    train state on the model's device. Gossip replicas start equal (the
    paper's w_0 at every node); they diverge through their batch slices."""
    opt = _make_opt(tcfg)
    model.init(gen)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    if tcfg.consensus == "gossip":
        G = tcfg.n_replicas
        params = {k: v.expand((G,) + v.shape).clone() for k, v in params.items()}
        one = opt.init({k: v[0] for k, v in params.items()})
        # the reference vmaps init over the replicas: every counter gains the axis
        opt_state = optim.tree_map(lambda x: x.expand((G,) + x.shape).clone(), one)
    else:
        opt_state = opt.init(params)
    return {"params": params, "opt": opt_state,
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module, params: dict):
    """Within the block, the model's parameter ``name`` is ``params[name]``
    (any tensor, views included), through the forward and the backward
    alike: a remat block recomputes its forward during the backward and must
    find the same tensors there. ``torch.func.functional_call`` restores the
    parameters when the forward returns, before any backward."""
    saved = []
    try:
        for name, t in params.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield model
    finally:
        for mod, leaf, old in reversed(saved):
            mod._parameters[leaf] = old


def _grads(leaves: dict) -> dict:
    """Each leaf's accumulated gradient, zeros where none reached it."""
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}


def make_train_step(model: Model, tcfg: TrainerConfig) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``, the metrics float32
    tensors ``loss``, ``ce`` and ``aux`` on the device. Nothing in the state
    passed in is modified.

    Gossip mode expects every batch leaf with a leading replica axis
    (G, per_replica_batch, ...). A Python loop runs the replicas one after
    another (the kernels are launched through ctypes, which
    ``torch.func.vmap`` cannot batch), each on leaves of its own with its own
    backward of its local loss, so a replica's remat recomputation sees its
    own weights. The reference differentiates the mean over the replicas and
    multiplies by G, which for a power-of-two G is exactly the local
    gradient taken here.
    """
    remat = dict(remat=tcfg.remat, remat_policy=tcfg.remat_policy)
    opt = _make_opt(tcfg)

    if tcfg.consensus == "gossip":
        G = tcfg.n_replicas
        clip = optim.clip_by_global_norm(tcfg.clip_norm, lead=1)
        payload = torch.bfloat16 if tcfg.gossip_payload == "bf16" else None

        def step_fn(state, batch):
            losses, ces, auxes, per = [], [], [], []
            for g in range(G):
                leaves = {k: v[g].detach().requires_grad_() for k, v in state["params"].items()}
                with swapped_params(model, leaves):
                    loss, metrics = model.loss({k: v[g] for k, v in batch.items()}, **remat)
                    loss.backward(inputs=list(leaves.values()))
                per.append(_grads(leaves))
                del leaves
                losses.append(loss.detach())
                ces.append(metrics["ce"].detach())
                auxes.append(metrics["aux"].detach())
            with torch.no_grad():
                grads = {k: torch.stack([p.pop(k) for p in per]) for k in state["params"]}
                del per
                if tcfg.clip_norm:
                    grads, _ = clip.update(grads, (), None)
                updates, opt_state = opt.update(grads, state["opt"], state["params"])
                del grads
                params = optim.apply_updates(state["params"], updates)
                del updates
                if int(state["step"]) % tcfg.mix_every == 0:
                    params = gossip_mix_stacked(params, int(state["step"]), n_nodes=G,
                                                rounds=tcfg.gossip_rounds,
                                                self_share=tcfg.gossip_self_share,
                                                payload_dtype=payload)
            new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
            return new_state, {"loss": torch.stack(losses).mean(),
                               "ce": torch.stack(ces).mean(), "aux": torch.stack(auxes).mean()}

        return step_fn

    clip = optim.clip_by_global_norm(tcfg.clip_norm)

    def step_fn(state, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in state["params"].items()}
        with swapped_params(model, leaves):
            loss, metrics = model.loss(batch, **remat)
            loss.backward(inputs=list(leaves.values()))
        with torch.no_grad():
            grads = _grads(leaves)
            del leaves
            if tcfg.clip_norm:
                grads, _ = clip.update(grads, (), None)
            updates, opt_state = opt.update(grads, state["opt"], state["params"])
            del grads
            params = optim.apply_updates(state["params"], updates)
        new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                           "aux": metrics["aux"].detach()}

    return step_fn


def make_prefill_step(model: Model) -> Callable:
    """Full-sequence inference forward (the prefill_32k shape): batch -> logits."""

    def prefill(batch):
        with torch.no_grad():
            logits, _ = model.forward(batch)
        return logits

    return prefill


def make_serve_step(model: Model) -> Callable:
    """One-token decode against a seq_len-deep cache (decode shapes):
    (tokens (B, 1), caches, pos) -> (logits (B, 1, V), caches)."""

    def serve(tokens, caches, pos):
        with torch.no_grad():
            return model.decode_step(tokens, caches, pos)

    return serve
