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

``--mode pegasos`` trains the paper's centralised baseline as Table 3 runs
it (``pegasos_train(X_train, y_train, lam, n_iters=1200, batch_size=8)``)
on the whole training set; ``--mode multiclass`` trains one-vs-rest GADGET
(``gadget_train_multiclass``: 10 nodes, λ 1e-3, B = 8, R = 4, the random
topology, 1,200 iterations, ``check_every`` 300) on data of LibSVM mnist's
shape (60,000 × 780 train, 10,000 test, 10 classes) from
``tests/test_multiclass.py``'s generator (Gaussian class centres ×3 plus
unit noise, numpy seed 0), and prints its test accuracy (argmax) and the
mean over classes of each one-vs-rest primal objective. Both take
``--impl torch``. ``chip_smoke.py`` phase 20 sets its limits from them.
``--mode cutting_plane`` runs Table 4's cutting-plane SVM on node 0's
partition (``PAPER_RUNS[name].n_nodes`` nodes, partition seed 0) over 5 and
60 cuts, on the float32 data and on the same numbers widened to float64,
and prints each run's cuts, gap, objective and test accuracy and the
largest difference between the two runs' w: how far rounding alone moves
the solver (``chip_smoke.py`` phase 20 holds the card's w against the CPU
over the 5-cut prefix and the full run's objective by the gap).

Usage:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py ccat \\
        --scale 0.1 --sparse --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py reuters \\
        --drop-prob 0.1 --drop link --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py ccat \\
        --scale 0.1 --sparse --impl torch --draws mix32 --seeds $(seq 0 47)
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py reuters \\
        --mode pegasos --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py mnist \\
        --mode multiclass --seeds 0 1
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py reuters \\
        --mode cutting_plane [--impl torch]
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


PEGASOS_ITERS, PEGASOS_BATCH = 1200, 8          # benchmarks/table3_gadget_vs_pegasos.py
MULTICLASS_SHAPE = (60_000, 10_000, 780, 10)    # LibSVM mnist: train, test, d, classes
MULTICLASS_CFG = dict(lam=1e-3, batch_size=8, gossip_rounds=4, topology="random",
                      max_iters=1200, check_every=300)
MULTICLASS_NODES = 10


def make_multiclass(n: int, d: int, C: int, seed: int = 0):
    """tests/test_multiclass.py's generator: Gaussian class centres ×3 plus
    unit noise; float32 X, int32 labels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, d)) * 3.0
    y = rng.integers(0, C, size=n)
    X = centers[y] + rng.normal(size=(n, d))
    return X.astype(np.float32), y.astype(np.int32)


def multiclass_objective(W: np.ndarray, X: np.ndarray, y: np.ndarray, lam: float) -> float:
    """Mean over classes of the one-vs-rest primal objective of W (C, d)."""
    y_bin = np.where(y[:, None] == np.arange(W.shape[0])[None, :], 1.0, -1.0)
    hinge = np.maximum(0.0, 1.0 - y_bin * (X @ W.T)).mean(axis=0)
    return float(np.mean(0.5 * lam * np.sum(W.astype(np.float64) ** 2, axis=1) + hinge))


def _baseline(args) -> None:
    """``--mode pegasos`` and ``--mode multiclass``: one JSON line a seed."""
    t0 = time.perf_counter()
    if args.mode == "pegasos":
        ds = make_dataset(args.name, scale=args.scale, seed=0)
        X, y, Xte, yte, lam = ds.X_train, ds.y_train, ds.X_test, ds.y_test, ds.lam
    else:
        n, n_te, d, C = MULTICLASS_SHAPE
        Xall, yall = make_multiclass(n + n_te, d, C, seed=0)
        X, y, Xte, yte = Xall[:n], yall[:n], Xall[n:], yall[n:]
        lam = MULTICLASS_CFG["lam"]
        n_i = n // MULTICLASS_NODES
        Xp = X[:MULTICLASS_NODES * n_i].reshape(MULTICLASS_NODES, n_i, d)
        yp = y[:MULTICLASS_NODES * n_i].reshape(MULTICLASS_NODES, n_i)
    gen_s = time.perf_counter() - t0
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode == "pegasos":
            if args.impl == "torch":
                from repro_torch.core.pegasos import pegasos_train as train
                res = train(X, y, lam, PEGASOS_ITERS, batch_size=PEGASOS_BATCH, seed=seed,
                            device="cpu")
            else:
                from repro.core.pegasos import pegasos_train as train
                res = train(jnp.asarray(X), jnp.asarray(y), lam, PEGASOS_ITERS,
                            batch_size=PEGASOS_BATCH, seed=seed)
            w = np.asarray(res.w)
            acc = float(np.mean(np.where(Xte @ w >= 0, 1.0, -1.0) == yte))
            objective, iters = float(np.asarray(res.objective)), PEGASOS_ITERS
        else:
            if args.impl == "torch":
                from repro_torch.core import gadget as TG
                from repro_torch.core.multiclass import gadget_train_multiclass
                res = gadget_train_multiclass(Xp, yp, C, TG.GadgetConfig(
                    **MULTICLASS_CFG, seed=seed), device="cpu")
            else:
                from repro.core.gadget import GadgetConfig
                from repro.core.multiclass import gadget_train_multiclass
                res = gadget_train_multiclass(jnp.asarray(Xp), jnp.asarray(yp), C,
                                              GadgetConfig(**MULTICLASS_CFG, seed=seed))
            W = np.asarray(res.w_consensus)
            acc = float(np.mean(np.argmax(Xte @ W.T, axis=1) == yte))
            objective, iters = multiclass_objective(W, X, y, lam), res.iters
        print(json.dumps({"impl": args.impl, "mode": args.mode, "dataset": args.name,
                          "n_train": int(len(y)), "n_test": int(len(yte)),
                          "d": int(X.shape[1]), "seed": seed, "iters": iters,
                          "test_accuracy": acc, "objective": objective,
                          "generate_s": gen_s, "train_s": time.perf_counter() - t0}),
              flush=True)


def _cutting_plane(args) -> None:
    """``--mode cutting_plane``: one JSON line for each cut limit."""
    ds = make_dataset(args.name, scale=args.scale, seed=0)
    Xp, yp, nc = partition(ds.X_train, ds.y_train, PAPER_RUNS[args.name].n_nodes, seed=0)
    X0, y0 = np.asarray(Xp[0, :int(nc[0])]), np.asarray(yp[0, :int(nc[0])])
    if args.impl == "torch":
        from repro_torch.core.cutting_plane import cutting_plane_svm as cp_torch

        def solve(X, y, cuts):
            res = cp_torch(X, y, ds.lam, max_cuts=cuts, device="cpu")
            return res._replace(w=res.w.numpy())
    else:
        from repro.core.cutting_plane import cutting_plane_svm

        def solve(X, y, cuts):
            return cutting_plane_svm(X, y, ds.lam, max_cuts=cuts)
    for cuts in (5, 60):
        runs = {}
        for dtype in (np.float32, np.float64):
            t0 = time.perf_counter()
            res = solve(X0.astype(dtype), y0.astype(dtype), cuts)
            acc = float(np.mean(np.where(ds.X_test @ res.w >= 0, 1.0, -1.0) == ds.y_test))
            runs[np.dtype(dtype).name] = dict(n_cuts=res.n_cuts, gap=res.gap,
                                              objective=res.objective, test_accuracy=acc,
                                              train_s=time.perf_counter() - t0, w=res.w)
        w_diff = float(np.abs(runs["float32"].pop("w") - runs["float64"].pop("w")).max())
        print(json.dumps({"impl": args.impl, "mode": args.mode, "dataset": args.name,
                          "rows": int(len(y0)), "max_cuts": cuts, "runs": runs,
                          "w_float32_vs_float64": w_diff}), flush=True)


def main() -> None:
    """Parse the arguments, train once per seed, print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=sorted(PAPER_RUNS))
    ap.add_argument("--mode", choices=("gadget", "pegasos", "multiclass", "cutting_plane"),
                    default="gadget",
                    help="GADGET (default), centralised Pegasos as Table 3 runs it, "
                         "one-vs-rest GADGET at mnist's shape, or Table 4's cutting plane "
                         "on node 0")
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
    if args.mode == "cutting_plane":
        _cutting_plane(args)
        return
    if args.mode != "gadget":
        _baseline(args)
        return

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
