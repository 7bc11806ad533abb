"""Model quality of the JAX reference on one of the paper's runs, on the CPU.

Trains ``repro.core.gadget.gadget_train`` with ``PAPER_RUNS[name]`` (10
nodes, B=1, R=4, random topology, the paper's λ) on
``make_dataset(name, scale, seed=0)``, once per draw seed, and prints the
test accuracy of the consensus (sign of the margin, +1 at 0) and the final
primal objective. These are the numbers ``chip_smoke.py`` sets its quality
limits from. ``--drop-prob`` (with ``--drop``, ``--dead`` and
``--fault-seed``) trains under the reference's ``FaultPlan`` and also prints
the run's least and greatest Push-Sum mass. ``--impl torch`` trains the
PyTorch port instead (``repro_torch.core.gadget.gadget_train`` on the CPU)
on the same data and config. Its own draws are the reference's, so it
gives the reference's numbers to float rounding; ``--draws`` swaps in
another draw source for the port, to compare streams over draw seeds:
``generator`` (one stateful ``torch.Generator`` advanced in call order, the
port's draws before the Threefry streams), ``mix32`` (a multiply-xorshift
hash of (seed, stream, t, …), the Threefry streams' first replacement) or
``lowbias32`` (the same hash with a stronger finaliser).

Usage:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py ccat \\
        --scale 0.1 --sparse --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py reuters \\
        --drop-prob 0.1 --drop link --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py ccat \\
        --scale 0.1 --sparse --impl torch --draws mix32 --seeds $(seq 0 47)
"""
from __future__ import annotations

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from repro.configs.gadget_svm import PAPER_RUNS
from repro.core.faults import FaultPlan
from repro.core.gadget import gadget_train
from repro.data.svm_datasets import make_dataset, partition


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x·c mod 2^32 with every product below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = _mul32(x ^ (x >> 16), 0x045D9F3B)
    x = _mul32(x ^ (x >> 16), 0x045D9F3B)
    return x ^ (x >> 16)


def _lowbias32(x):
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _draw_source(kind: str, seed: int):
    """A draw source for the port other than its own (see ``--draws``)."""
    import torch
    from repro_torch.core import topology as topo
    from repro_torch.core.push_sum import collapse_rounds

    def mixing(targets, plan):
        Bs = topo.random_neighbor_matrix_device(plan.m, targets=targets)
        return collapse_rounds(Bs) if plan.fused else Bs

    if kind == "generator":
        gen = torch.Generator().manual_seed(seed)

        class Stateful:
            def take(self, t0, n, plan):
                raw = torch.randint(0, 1 << 62, (n, plan.m, plan.batch_size), generator=gen)
                ids = raw % plan.counts[:, None]
                targets = torch.randint(0, plan.m - 1, (n, plan.rounds, plan.m), generator=gen)
                return ids, mixing(targets, plan)
        return Stateful()
    mix = {"mix32": _mix32, "lowbias32": _lowbias32}[kind]

    def bits(stream, *keys):
        h = 0x9E3779B9
        for k in (seed & _M32, (seed >> 32) & _M32, stream):
            h = mix(h ^ k)
        for k in keys:
            h = mix(h ^ k)
        return h

    class Hashed:
        def take(self, t0, n, plan):
            ar = lambda k: torch.arange(k, dtype=torch.int64)  # noqa: E731
            t = (ar(n) + t0)[:, None, None]
            ids = bits(1, t, ar(plan.m)[None, :, None], ar(plan.batch_size)[None, None, :])
            targets = bits(2, t, ar(plan.rounds)[None, :, None], ar(plan.m)[None, None, :])
            return ids % plan.counts[None, :, None], mixing(targets % (plan.m - 1), plan)
    return Hashed()


def _torch_train(Xp, yp, cfg, n_counts, draws="own"):
    """The port's gadget_train on the CPU with the same config; numpy out."""
    from repro_torch.core import gadget as TG
    from repro_torch.core.faults import FaultPlan as TorchPlan
    fields = {k: v for k, v in cfg._asdict().items() if k in TG.GadgetConfig._fields}
    if cfg.faults is not None:
        fields["faults"] = TorchPlan(*cfg.faults)
    if draws != "own" and (cfg.faults is not None or cfg.topology != "random"):
        raise SystemExit("--draws other than own takes a fault-free random-topology run")
    source = None if draws == "own" else _draw_source(draws, cfg.seed)
    res = TG.gadget_train(Xp, yp, TG.GadgetConfig(**fields), n_counts=n_counts,
                          device="cpu", draws=source)
    return res._replace(w_consensus=res.w_consensus.numpy())


def main() -> None:
    """Parse the arguments, train once per seed, print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=sorted(PAPER_RUNS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sparse", action="store_true", help="ELL features")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--drop-prob", type=float, default=None,
                    help="train under FaultPlan(drop_prob=...)")
    ap.add_argument("--drop", choices=("link", "message"), default="link")
    ap.add_argument("--dead", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--impl", choices=("jax", "torch"), default="jax",
                    help="the JAX reference or the PyTorch port (on the CPU)")
    ap.add_argument("--draws", choices=("own", "generator", "mix32", "lowbias32"),
                    default="own", help="with --impl torch: the port's draw source")
    args = ap.parse_args()

    run = PAPER_RUNS[args.name]
    cfg = run.gadget
    faults = None
    if args.drop_prob is not None:
        faults = FaultPlan(drop_prob=args.drop_prob, drop=args.drop,
                           dead_nodes=tuple(args.dead), seed=args.fault_seed)
        cfg = cfg._replace(faults=faults)
    if args.max_iters is not None:
        cfg = cfg._replace(max_iters=args.max_iters)
    t0 = time.perf_counter()
    ds = make_dataset(args.name, scale=args.scale, seed=0, sparse=args.sparse)
    gen_s = time.perf_counter() - t0
    Xp, yp, n_counts = partition(ds.X_train, ds.y_train, run.n_nodes, seed=0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.impl == "torch":
            res = _torch_train(Xp, yp, cfg._replace(seed=seed), n_counts, args.draws)
        else:
            res = gadget_train(Xp, jnp.asarray(yp), cfg._replace(seed=seed),
                               n_counts=n_counts)
        w = np.asarray(res.w_consensus)
        scores = ds.X_test.matvec(w) if args.sparse else ds.X_test @ w
        acc = float(np.mean(np.where(scores >= 0, 1.0, -1.0) == ds.y_test))
        print(json.dumps({"impl": args.impl, "draws": args.draws, "dataset": args.name,
                          "scale": args.scale,
                          "sparse": args.sparse,
                          "n_train": int(len(ds.y_train)), "n_test": int(len(ds.y_test)),
                          "d": ds.d, "seed": seed, "iters": res.iters,
                          "test_accuracy": acc,
                          "objective": float(res.objective_trace[-1]),
                          "majority_class": float(max(np.mean(ds.y_test > 0),
                                                      np.mean(ds.y_test < 0))),
                          "faults": None if faults is None else faults._asdict(),
                          "mass_min": float(np.min(res.mass_trace)),
                          "mass_max": float(np.max(res.mass_trace)),
                          "generate_s": gen_s, "train_s": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
