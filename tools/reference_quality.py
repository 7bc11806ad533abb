"""Model quality of the JAX reference on one of the paper's runs, on the CPU.

Trains ``repro.core.gadget.gadget_train`` with ``PAPER_RUNS[name]`` (10
nodes, B=1, R=4, random topology, the paper's λ) on
``make_dataset(name, scale, seed=0)``, once per draw seed, and prints the
test accuracy of the consensus (sign of the margin, +1 at 0) and the final
primal objective. These are the numbers ``chip_smoke.py`` sets its quality
limits from.

Usage:
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_quality.py ccat \\
        --scale 0.1 --sparse --seeds 0 1
"""
from __future__ import annotations

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from repro.configs.gadget_svm import PAPER_RUNS
from repro.core.gadget import gadget_train
from repro.data.svm_datasets import make_dataset, partition


def main() -> None:
    """Parse the arguments, train once per seed, print one JSON line each."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=sorted(PAPER_RUNS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--sparse", action="store_true", help="ELL features")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()

    run = PAPER_RUNS[args.name]
    t0 = time.perf_counter()
    ds = make_dataset(args.name, scale=args.scale, seed=0, sparse=args.sparse)
    gen_s = time.perf_counter() - t0
    Xp, yp, n_counts = partition(ds.X_train, ds.y_train, run.n_nodes, seed=0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = gadget_train(Xp, jnp.asarray(yp), run.gadget._replace(seed=seed),
                           n_counts=n_counts)
        w = np.asarray(res.w_consensus)
        scores = ds.X_test.matvec(w) if args.sparse else ds.X_test @ w
        acc = float(np.mean(np.where(scores >= 0, 1.0, -1.0) == ds.y_test))
        print(json.dumps({"dataset": args.name, "scale": args.scale, "sparse": args.sparse,
                          "n_train": int(len(ds.y_train)), "n_test": int(len(ds.y_test)),
                          "d": ds.d, "seed": seed, "iters": res.iters,
                          "test_accuracy": acc,
                          "objective": float(res.objective_trace[-1]),
                          "majority_class": float(max(np.mean(ds.y_test > 0),
                                                      np.mean(ds.y_test < 0))),
                          "generate_s": gen_s, "train_s": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
