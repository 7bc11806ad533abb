"""Dry-run of the production meshes, the port of ``repro.launch.dryrun``:
every (arch x shape x mesh x consensus) traced once on rank 0 of a fake
world, with per-device bytes, FLOPs, collective bytes and the roofline term
that bounds the step, computed for NVIDIA H100 cards.

Nothing is materialised and no card is needed: the world is the ``fake``
process-group backend (``launch.mesh.fake_world``: 256 ranks as 16 x 16,
512 as 2 x 16 x 16), the tensors are fake (``FakeTensorMode``), the state
and the batch are DTensors with the specs of ``launch.shardings``, and one
step runs as the port runs it (a train step's forward, backward and
update; a prefill; or a decode step), B10-B12 through their fake
implementations and sharding rules. Fake tensors are CUDA tensors where
PyTorch has CUDA, else CPU tensors (autograd over fake CUDA tensors needs
a CUDA build); the counts are the same, but on a CPU mesh DTensor runs an
all-to-all as an all-gather and a chunk, and records it so.

The record's numbers are eager per-op counts of rank 0's local work, not
XLA's fused ones: each op a dispatch counter sees below DTensor (local
shapes) adds its FLOPs (``torch.utils.flop_counter``'s formulas, and the
kernels' own) and its inputs' and outputs' bytes (views move none); the
``_c10d_functional`` collectives DTensor issues and the gossip's
point-to-point shares go to ``hlo_parse.CollectiveRecorder`` under the
reference's ring conventions; the peak is the state's and the batch's
local bytes plus the most bytes the step's own tensors held at once.
Replicated compute counts in full on every rank, as XLA's per-device count
does. The port's layers run as a Python loop, so every layer is counted and
the reference's ``analysis.py`` (its correction of XLA's count of a
``while`` body) has no counterpart.

The roofline uses the H100 SXM data sheet's peaks at its 700 W power
limit: 989 TFLOP/s bf16 dense, 3.35 TB/s of HBM, NVLink 450 GB/s each way.
Its times are predictions computed on the host, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
  ... --multi-pod            (2 x 16 x 16 mesh; default single-pod 16 x 16)
  ... --consensus gossip     (paper technique; gossip axis = pod or data)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time
import weakref
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, InputShape, skip_reason
from repro_torch.launch import input_specs as ispecs
from repro_torch.launch import shardings as shard
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.hlo_parse import FUNCTIONAL_OPS, CollectiveRecorder
from repro_torch.launch.mesh import fake_world, make_host_mesh, make_production_mesh
from repro_torch.sharding.api import AxisRules, PartitionSpec as P, activate

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CARD", "model_flops", "count_params",
           "count_active_params", "DryrunResult", "StepCounter", "run_one", "main"]

# ------------------------------------------------------------ HW constants
CARD = "NVIDIA H100 SXM, data sheet, 700 W power limit"
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # NVLink bytes/s per card, each way


def model_flops(cfg, shape: InputShape, n_params_active: int, n_params_total: int) -> float:
    """6*N*D with N = active params (MoE counts top-k+shared experts only)."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_params_active * tokens


def count_params(params: dict) -> int:
    return sum(math.prod(t.shape) for t in params.values())


def count_active_params(cfg, params: dict) -> int:
    """Total params minus the non-routed share of expert weights."""
    total = count_params(params)
    if cfg.moe is None:
        return total
    expert = sum(math.prod(t.shape) for name, t in params.items()
                 if re.search(r"ch/w[igo]$", shard._path_str(name)))
    return total - expert + int(expert * cfg.moe.top_k / cfg.moe.n_experts)


@dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    consensus: str
    status: str                  # ok | skipped | failed
    reason: str = ""
    compile_secs: float = 0.0    # seconds to trace the step
    per_device_bytes: int = 0    # args + the step's own peak
    arg_bytes: int = 0
    temp_bytes: int = 0
    hlo_flops: float = 0.0       # per device, every op counted (eager)
    hlo_bytes: float = 0.0       # per device
    collective_bytes: float = 0.0
    rolled_flops: float = 0.0    # = hlo_flops: no while bodies to correct
    collectives: dict | None = None
    n_params: int = 0
    n_params_active: int = 0
    model_flops_global: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flop_ratio: float = 0.0


# ------------------------------------------------------------ the counter

def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh")


class StepCounter(TorchDispatchMode):
    """Rank 0's local work of the ops dispatched inside it, counted below
    DTensor (an op on DTensors is passed on to DTensor, whose ops on the
    local shards come back here): ``flops`` from ``torch.utils.flop_counter``'s
    formulas (the kernels register their own); ``bytes``, every non-view
    op's inputs and outputs; the ``_c10d_functional`` collectives into
    ``recorder``; and ``peak``, the most bytes the storages made inside held
    at once (each counted until it is freed). DTensor's sharding propagation
    runs each new op once more on fake tensors of the global shapes to learn
    the output's metadata; those ops are not counted."""

    def __init__(self, recorder: CollectiveRecorder):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.recorder = recorder
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs and self._refs[key]() is st:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            op = FUNCTIONAL_OPS.get(name)
            if op is not None:
                self.recorder.record(op, sum(map(_nbytes, _tensors(out))),
                                     _group_size(func, args))
            return out
        fn = self.registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        if func.is_view:
            return out
        if name not in _NO_BYTES:
            self.bytes += sum(map(_nbytes, ins + outs))
        # an output on an input's storage (in place, ``_unsafe_view``) is no new memory
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in held:
                self._track(t)
        return out


def _in_propagation() -> bool:
    """True inside DTensor's metadata propagation
    (``ShardingPropagator._propagate_tensor_meta*``)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


def _group_size(func, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = func._overloadpacket.__name__
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    return _resolve_process_group(args[-1]).size()


# ------------------------------------------------------------ one combo

def _roofline(res: DryrunResult, n_chips: int) -> None:
    res.compute_s = res.hlo_flops / PEAK_FLOPS
    res.memory_s = res.hlo_bytes / HBM_BW
    res.collective_s = res.collective_bytes / LINK_BW
    terms = {"compute": res.compute_s, "memory": res.memory_s,
             "collective": res.collective_s}
    res.bottleneck = max(terms, key=terms.get)
    global_hlo_flops = res.hlo_flops * n_chips
    res.useful_flop_ratio = (res.model_flops_global / global_hlo_flops
                             if global_hlo_flops else 0.0)


def _param_mode(params: dict, param_mode: str) -> str:
    """"auto": ZeRO-1 (weights TP-only, moments data-sharded) below 60 GB of
    parameters, FSDP above, as the reference picks."""
    if param_mode != "auto":
        return param_mode
    nbytes = sum(_nbytes(t) for t in params.values())
    return "zero1" if nbytes < 60e9 else "fsdp"


def _fake_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            consensus: str = "allreduce", remat: bool = False,
            verbose: bool = True, extra_tag: str = "",
            param_mode: str = "auto", seq_shard: bool = False,
            remat_policy: str = "full", swa_variant: bool = False,
            n_layers: int | None = None, shape: InputShape | None = None,
            mesh_shape: tuple[int, int] | None = None, dtype: torch.dtype = torch.bfloat16,
            optimizer: str = "adamw") -> DryrunResult:
    """The record of one combo. Beside the reference's arguments:
    ``n_layers`` cuts the depth, ``shape`` replaces ``SHAPES[shape_name]``,
    ``mesh_shape`` (data, model) replaces the production mesh by a host
    mesh of that many ranks, ``dtype`` is the parameters' and activations'
    type (bf16 as in the reference) and ``optimizer`` the trainer's."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = shape if shape is not None else SHAPES[shape_name]
    arch_label = arch
    if swa_variant and not cfg.subquadratic() and not cfg.is_encoder:
        # sliding-window variant of a full-attention arch: the sanctioned
        # carve-in that makes long_500k runnable for dense models. Reported
        # as "<arch>+swa" — a variant, not the assigned config.
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}+swa",
            block_pattern=tuple("swa" for _ in cfg.block_pattern), window=4096)
        arch_label = f"{arch}+swa"
    if mesh_shape is not None:
        mesh_name = f"{mesh_shape[0]}x{mesh_shape[1]}"
        n_chips = mesh_shape[0] * mesh_shape[1]
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        n_chips = 512 if multi_pod else 256
    res = DryrunResult(arch=arch_label, shape=shape_name, mesh=mesh_name + (extra_tag or ""),
                       consensus=consensus, status="ok")

    why = skip_reason(cfg, shape)
    gossip = consensus == "gossip"
    if not why and gossip and shape.kind != "train":
        why = "gossip consensus applies to training only"
    if why:
        res.status, res.reason = "skipped", why
        if verbose:
            _print_result(res)
        return res

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.mesh import Mesh
    from repro_torch.models.transformer import Model

    t0 = time.time()
    dev = _fake_device()
    recorder = CollectiveRecorder()
    try:
        with fake_world(n_chips):
            mesh = (make_host_mesh(*mesh_shape, device_type=dev) if mesh_shape is not None
                    else make_production_mesh(multi_pod, device_type=dev))
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            replica_axis = "pod" if "pod" in sizes else "data"
            n_replicas = sizes[replica_axis] if gossip else 1
            # logical-axis rules: batch over the DP axes (minus the gossip
            # replica axis, whose replicas step on the sub-mesh), vocab on `model`
            batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
            rule_batch = tuple(a for a in batch_axes if not (gossip and a == replica_axis))
            rules = AxisRules(mesh, {
                "batch": rule_batch or None, "seq": ("model" if seq_shard else None),
                "embed": None, "vocab": "model", "mlp": "model", "expert": None,
                "capacity": None, "heads_dec": None, "cache_seq": "model"})
            comm = Mesh(sizes)
            comm.recorder = recorder
            fake = FakeTensorMode(allow_non_fake_inputs=True)
            with fake, activate(rules):
                model = Model(cfg, device=dev, dtype=dtype, param_dtype=dtype)
                if shape.kind == "train":
                    tcfg = steps_mod.TrainerConfig(
                        optimizer=optimizer, consensus=consensus, n_replicas=n_replicas,
                        replica_axis=replica_axis, remat=remat, remat_policy=remat_policy)
                    state = steps_mod.make_train_state(model, tcfg, None)
                    params = state["params"]
                    mode = _param_mode({k: v[0] if gossip else v for k, v in params.items()},
                                       param_mode)
                    pspecs = shard.param_specs(mesh, params, gossip=gossip,
                                               replica_axis=replica_axis, mode=mode)
                    mspecs = shard.param_specs(mesh, params, gossip=gossip,
                                               replica_axis=replica_axis, mode="fsdp")
                    sspecs = steps_mod.train_state_specs(pspecs, tcfg, moment_specs=mspecs)
                    bspecs = shard.batch_specs(mesh, cfg, shape, gossip_stacked=gossip,
                                               replica_axis=replica_axis)
                    bshapes = ispecs.train_batch_shapes(
                        cfg, shape, n_replicas=n_replicas if gossip else 0, act_dtype=dtype,
                        device=dev)
                    dstate = shard.distribute(mesh, state, sspecs)
                    dbatch = shard.distribute(mesh, bshapes, bspecs)
                    del state
                    res.arg_bytes = shard.local_bytes(dstate) + shard.local_bytes(dbatch)
                    dstate["step"] = 0  # the host's counter: a fake tensor has no value to read
                    step = steps_mod.make_train_step(model, tcfg, mesh=comm)
                    run = lambda: step(dstate, dbatch)  # noqa: E731
                    n_params = count_params({k: v[0] if gossip else v
                                             for k, v in params.items()})
                    n_active = count_active_params(cfg, {k: v[0] if gossip else v
                                                         for k, v in params.items()})
                else:
                    params = {k: v.detach() for k, v in model.state_dict().items()}
                    mode = _param_mode(params, param_mode)
                    dparams = shard.distribute(mesh, params,
                                               shard.param_specs(mesh, params, mode=mode))
                    n_params, n_active = count_params(params), count_active_params(cfg, params)
                    if shape.kind == "prefill":
                        bshapes = ispecs.train_batch_shapes(cfg, shape, act_dtype=dtype,
                                                            device=dev)
                        dbatch = shard.distribute(mesh, bshapes,
                                                  shard.batch_specs(mesh, cfg, shape))
                        res.arg_bytes = shard.local_bytes(dparams) + shard.local_bytes(dbatch)
                        prefill = steps_mod.make_prefill_step(model)

                        def run():
                            with steps_mod.swapped_params(model, dparams):
                                return prefill(dbatch)
                    else:  # decode
                        tokens, caches, pos = ispecs.decode_input_shapes(model, shape)
                        dcaches = shard.distribute(mesh, caches,
                                                   shard.cache_spec_tree(mesh, caches))
                        n_batch = math.prod(sizes[a] for a in batch_axes)
                        tok_spec = (P(batch_axes, None) if shape.global_batch % n_batch == 0
                                    else P(None, None))
                        dtokens = shard.distribute(mesh, tokens, tok_spec)
                        res.arg_bytes = (shard.local_bytes(dparams) + shard.local_bytes(dcaches)
                                         + shard.local_bytes(dtokens))
                        serve = steps_mod.make_serve_step(model)

                        def run():
                            with steps_mod.swapped_params(model, dparams):
                                return serve(dtokens, dcaches, pos)
                del params
                with StepCounter(recorder) as counter:
                    out = run()
                    end_bytes = counter.live
                del out
        res.compile_secs = time.time() - t0
        res.per_device_bytes = res.arg_bytes + counter.peak
        res.temp_bytes = counter.peak - end_bytes
        res.hlo_flops = res.rolled_flops = float(counter.flops)
        res.hlo_bytes = float(counter.bytes)
        res.collectives = recorder.summary()
        res.collective_bytes = float(res.collectives["total_bytes"])
        res.n_params, res.n_params_active = n_params, n_active
        res.model_flops_global = model_flops(cfg, shape, n_active, n_params)
        _roofline(res, n_chips)
    except Exception as e:  # noqa: BLE001 — dry-run failures are data
        res.status = "failed"
        res.reason = f"{type(e).__name__}: {e}"[:500]
        res.compile_secs = time.time() - t0
    if verbose:
        _print_result(res)
    return res


def _print_result(res: DryrunResult) -> None:
    if res.status != "ok":
        print(f"[{res.status}] {res.arch} x {res.shape} ({res.mesh}, {res.consensus}): {res.reason}")
        return
    print(f"[ok] {res.arch} x {res.shape} ({res.mesh}, {res.consensus}) "
          f"traced={res.compile_secs:.1f}s")
    print(f"     per-device bytes: args={res.arg_bytes/2**30:.2f}GiB "
          f"temp={res.temp_bytes/2**30:.2f}GiB total={res.per_device_bytes/2**30:.2f}GiB")
    print(f"     per-device eager: flops={res.hlo_flops:.3e} bytes={res.hlo_bytes:.3e} "
          f"collective_bytes={res.collective_bytes:.3e}")
    print(f"     roofline ({CARD}): compute={res.compute_s*1e3:.2f}ms "
          f"memory={res.memory_s*1e3:.2f}ms collective={res.collective_s*1e3:.2f}ms "
          f"-> {res.bottleneck}-bound; useful-flop ratio={res.useful_flop_ratio:.2f}")
    if res.collectives and res.collectives["count_by_op"]:
        print(f"     collectives: {res.collectives['count_by_op']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--consensus", default="allreduce", choices=("allreduce", "gossip"))
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=True,
                    help="activation-checkpoint each block in train steps")
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    ap.add_argument("--swa-variant", action="store_true",
                    help="replace full attention with SWA(4096) — unlocks "
                         "long_500k for dense archs, labeled '<arch>+swa'")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-style sequence parallelism: residual stream "
                         "sharded on `model` between blocks")
    ap.add_argument("--param-mode", default="auto", choices=("auto", "fsdp", "zero1"),
                    help="weight sharding: fsdp (ZeRO-3), zero1 (TP-only weights, "
                         "data-sharded moments), or auto by model size")
    ap.add_argument("--out", help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_fail = 0
    records = []
    for a, s, mp in combos:
        res = run_one(a, s, multi_pod=mp, consensus=args.consensus, remat=args.remat,
                      param_mode=args.param_mode, seq_shard=args.seq_shard,
                      remat_policy=args.remat_policy, swa_variant=args.swa_variant)
        records.append(res)
        n_fail += res.status == "failed"
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(asdict(res)) + "\n")
    ok = sum(r.status == "ok" for r in records)
    sk = sum(r.status == "skipped" for r in records)
    print(f"\n== dry-run summary: {ok} ok, {sk} skipped, {n_fail} failed "
          f"of {len(records)} ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
