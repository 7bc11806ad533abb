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

Every step takes DTensor state and batches as it takes plain tensors (the
specs of ``launch.shardings`` and :func:`train_state_specs`; plain tensors
beside DTensors count as replicated). In gossip mode on a mesh the replica
axis is a mesh dim (``TrainerConfig.replica_axis``): each rank holds its
replica's shard, the replica's loss and backward run on the sub-mesh of
the other dims, and the mix is Push-Sum over the replica axis, point to
point (``core.consensus.gossip_mix_axis``), with ``gossip_mix_stacked``'s
schedule.

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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import optim
from repro_torch.core.consensus import gossip_mix_axis, gossip_mix_stacked
from repro_torch.core.mesh import Mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding.api import PartitionSpec as P

Pytree = Any

__all__ = ["TrainerConfig", "make_train_state", "make_train_step", "make_serve_step",
           "make_prefill_step", "swapped_params", "train_state_specs"]


@dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "adamw"        # adamw | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    consensus: str = "allreduce"    # allreduce | gossip
    n_replicas: int = 1             # gossip replicas (== the replica axis' size on a mesh)
    replica_axis: str = "pod"       # the mesh axis the replicas live on
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
    """Each leaf's accumulated gradient, zeros where none reached it; a
    DTensor's gradient in its leaf's placements (where the optimizer's
    state and the update live: FSDP's reduce-scatter)."""
    def grad(v):
        g = v.grad if v.grad is not None else torch.zeros_like(v)
        if _is_dtensor(g) and tuple(g.placements) != tuple(v.placements):
            g = g.redistribute(v.device_mesh, v.placements)
        return g

    return {k: grad(v) for k, v in leaves.items()}


def _step_int(step: torch.Tensor) -> int:
    """The step counter as a Python int (a replicated DTensor's local value)."""
    return int(step.to_local()) if _is_dtensor(step) else int(step)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _replicated_mix():
    """DTensor treats plain tensors beside DTensors (positions, masks,
    zeros) as replicated within the block."""
    return implicit_replication()


class _ReplicaViews:
    """This rank's replica of (G, ...) DTensors on a mesh whose ``axis`` is
    the replica axis: the replica as a DTensor on the sub-mesh of the other
    dims, and back. A leaf sharded on ``axis`` holds one replica a rank; a
    leaf replicated there (the optimizer's (G,) step counters, equal for
    every replica) is indexed at this rank's replica and broadcast back."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.names = tuple(mesh.mesh_dim_names)
        self.i = self.names.index(axis)
        rest = tuple(n for n in self.names if n != axis)
        if not rest:
            raise ValueError(f"gossip on a mesh needs a dim besides the replica axis {axis!r}")
        self.sub = mesh[rest]
        self.g = mesh.get_local_rank(axis)

    def _stacked(self, x) -> bool:
        return isinstance(x.placements[self.i], Shard)

    def replica(self, x):
        local = x.to_local()[0 if self._stacked(x) else self.g]
        pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for n, p in zip(self.names, x.placements) if n != self.axis)
        return DTensor.from_local(local, self.sub, pl, run_check=False, shape=x.shape[1:],
                                  stride=x.stride()[1:])

    def stacked(self, y, like):
        local = y.to_local().unsqueeze(0)
        if not self._stacked(like):
            local = local.expand(like.to_local().shape).clone()
        return DTensor.from_local(local, self.mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())

    def mean(self, y):
        """The mean over the replicas of a scalar, replicated on the sub-mesh
        (a DTensor) or the same on every rank of it (a plain tensor)."""
        pl = tuple(Shard(0) if n == self.axis else Replicate() for n in self.names)
        local = y.to_local() if isinstance(y, DTensor) else y
        return DTensor.from_local(local.reshape(1), self.mesh, pl, run_check=False,
                                  shape=(self.mesh.size(self.i),), stride=(1,)).mean()


def make_train_step(model: Model, tcfg: TrainerConfig, *, mesh: Mesh | None = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``, the metrics float32
    tensors ``loss``, ``ce`` and ``aux`` on the device. Nothing in the state
    passed in is modified.

    Gossip mode expects every batch leaf with a leading replica axis
    (G, per_replica_batch, ...). On plain tensors a Python loop runs the
    replicas one after another (the kernels are launched through ctypes,
    which ``torch.func.vmap`` cannot batch), each on leaves of its own with
    its own backward of its local loss, so a replica's remat recomputation
    sees its own weights. The reference differentiates the mean over the
    replicas and multiplies by G, which for a power-of-two G is exactly the
    local gradient taken here. On DTensors each rank steps its own replica
    on the sub-mesh and mixes over ``tcfg.replica_axis`` through ``mesh``
    (a ``core.mesh.Mesh`` of the world; built at the first step if None).
    """
    remat = dict(remat=tcfg.remat, remat_policy=tcfg.remat_policy)
    opt = _make_opt(tcfg)
    payload = torch.bfloat16 if tcfg.gossip_payload == "bf16" else None

    def value_and_grads(params, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with swapped_params(model, leaves):
            loss, metrics = model.loss(batch, **remat)
            loss.backward(inputs=list(leaves.values()))
        metrics = {k: metrics[k].detach() for k in ("ce", "aux")}
        return loss.detach(), metrics, _grads(leaves)

    def update(clip, grads, opt_state, params):
        with torch.no_grad():
            if tcfg.clip_norm:
                grads, _ = clip.update(grads, (), None)
            updates, opt_state = opt.update(grads, opt_state, params)
            del grads
            return optim.apply_updates(params, updates), opt_state

    if tcfg.consensus == "gossip":
        G = tcfg.n_replicas
        clip_stacked = optim.clip_by_global_norm(tcfg.clip_norm, lead=1)
        clip = optim.clip_by_global_norm(tcfg.clip_norm)
        comm = {"mesh": mesh}

        def stacked_step(state, batch):
            losses, ces, auxes, per = [], [], [], []
            for g in range(G):
                loss, metrics, grads = value_and_grads(
                    {k: v[g] for k, v in state["params"].items()},
                    {k: v[g] for k, v in batch.items()})
                per.append(grads)
                losses.append(loss)
                ces.append(metrics["ce"])
                auxes.append(metrics["aux"])
            with torch.no_grad():
                grads = {k: torch.stack([p.pop(k) for p in per]) for k in state["params"]}
                del per
                params, opt_state = update(clip_stacked, grads, state["opt"], state["params"])
                if _step_int(state["step"]) % tcfg.mix_every == 0:
                    params = gossip_mix_stacked(params, _step_int(state["step"]), n_nodes=G,
                                                rounds=tcfg.gossip_rounds,
                                                self_share=tcfg.gossip_self_share,
                                                payload_dtype=payload)
            new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
            return new_state, {"loss": torch.stack(losses).mean(),
                               "ce": torch.stack(ces).mean(), "aux": torch.stack(auxes).mean()}

        def mesh_step(state, batch):
            first = next(iter(state["params"].values()))
            views = _ReplicaViews(first.device_mesh, tcfg.replica_axis)
            if views.mesh.size(views.i) != G:
                raise ValueError(f"n_replicas {G} != the {tcfg.replica_axis!r} axis' "
                                 f"{views.mesh.size(views.i)} ranks")
            if comm["mesh"] is None:
                comm["mesh"] = Mesh(dict(zip(views.names, views.mesh.shape)))
            rep = {k: views.replica(v) for k, v in state["params"].items()}
            loss, metrics, grads = value_and_grads(
                rep, {k: views.replica(v) for k, v in batch.items()})
            opt_rep = optim.tree_map(views.replica, state["opt"])
            rep, opt_rep = update(clip, grads, opt_rep, rep)
            del grads
            with torch.no_grad():
                local = {k: v.to_local() for k, v in rep.items()}
                if _step_int(state["step"]) % tcfg.mix_every == 0:
                    local = gossip_mix_axis(local, _step_int(state["step"]), mesh=comm["mesh"],
                                            axis=tcfg.replica_axis, rounds=tcfg.gossip_rounds,
                                            self_share=tcfg.gossip_self_share,
                                            payload_dtype=payload)
                params = {k: DTensor.from_local(local[k].unsqueeze(0), like.device_mesh,
                                                like.placements, run_check=False,
                                                shape=like.shape, stride=like.stride())
                          for k, like in state["params"].items()}
                opt_state = optim.tree_map(views.stacked, opt_rep, state["opt"])
            new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
            return new_state, {"loss": views.mean(loss), "ce": views.mean(metrics["ce"]),
                               "aux": views.mean(metrics["aux"])}

        def step_fn(state, batch):
            with _replicated_mix():
                if _is_dtensor(next(iter(state["params"].values()))):
                    return mesh_step(state, batch)
                return stacked_step(state, batch)

        return step_fn

    clip = optim.clip_by_global_norm(tcfg.clip_norm)

    def step_fn(state, batch):
        with _replicated_mix():
            loss, metrics, grads = value_and_grads(state["params"], batch)
            params, opt_state = update(clip, grads, state["opt"], state["params"])
        new_state = {"params": params, "opt": opt_state, "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics}

    return step_fn


def make_prefill_step(model: Model) -> Callable:
    """Full-sequence inference forward (the prefill_32k shape): batch -> logits."""

    def prefill(batch):
        with torch.no_grad(), _replicated_mix():
            logits, _ = model.forward(batch)
        return logits

    return prefill


def make_serve_step(model: Model) -> Callable:
    """One-token decode against a seq_len-deep cache (decode shapes):
    (tokens (B, 1), caches, pos) -> (logits (B, 1, V), caches)."""

    def serve(tokens, caches, pos):
        with torch.no_grad(), _replicated_mix():
            return model.decode_step(tokens, caches, pos)

    return serve


# ------------------------------------------------------------------ specs

def train_state_specs(pspecs: dict, tcfg: TrainerConfig, moment_specs: dict | None = None):
    """Spec tree matching :func:`make_train_state`'s output, given param specs
    (which already include the gossip replica axis when applicable).

    ``moment_specs``: optional separate specs for the optimizer moments —
    ZeRO-1 passes FSDP-style (data-sharded) specs here while the params
    themselves stay TP-only. The step counters are scalars, or (G,) under
    gossip, replicated."""
    mspecs = moment_specs if moment_specs is not None else pspecs
    scalar = P() if tcfg.consensus != "gossip" else P(None)
    if tcfg.optimizer == "adamw":
        opt_spec = optim.AdamState(step=scalar, mu=mspecs, nu=mspecs)
    else:
        opt_spec = (optim.MomentumState(momentum=mspecs), optim.ScheduleState(step=scalar))
    return {"params": pspecs, "opt": opt_spec, "step": P()}
