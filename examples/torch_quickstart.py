"""Quickstart on the PyTorch/CUDA port: the paper in one run.

1. Train a linear SVM with GADGET (10 gossiping nodes, random-neighbor
   Push-Sum — the paper's exact protocol) on a paper-signature dataset.
2. Compare against centralized Pegasos.
3. Show the consensus: every node ends up with (nearly) the same model.

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same data,
configs and printed lines. It runs on the CUDA card (GADGET's half-step is
the ``fleet_half_step`` kernel there); ``--device cpu`` runs the plain
PyTorch path instead.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import svm_objective as obj
from repro_torch.core.gadget import GadgetConfig, gadget_train
from repro_torch.core.pegasos import pegasos_train
from repro_torch.data.svm_datasets import make_dataset, partition

SCALE, N_ITERS, BATCH, N_NODES = 0.3, 1500, 8, 10


def centralized(ds, n_iters: int = N_ITERS, device=None):
    """Centralized Pegasos on the whole training set."""
    return pegasos_train(ds.X_train, ds.y_train, lam=ds.lam, n_iters=n_iters,
                         batch_size=BATCH, device=device)


def gadget(ds, n_iters: int = N_ITERS, device=None):
    """GADGET over ``N_NODES`` partitions: random topology, R = 4, ε 1e-3."""
    Xp, yp, nc = partition(ds.X_train, ds.y_train, m=N_NODES)
    return gadget_train(Xp, yp, n_counts=nc, device=device,
                        cfg=GadgetConfig(lam=ds.lam, batch_size=BATCH, gossip_rounds=4,
                                         topology="random", epsilon=1e-3,
                                         max_iters=n_iters, check_every=300))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_dataset("reuters", scale=SCALE, seed=0)
    Xte = torch.from_numpy(ds.X_test).to(dev)
    yte = torch.from_numpy(ds.y_test).to(dev)
    print(f"dataset=reuters(synthetic signature) d={ds.d} "
          f"n_train={len(ds.y_train)} lambda={ds.lam}")

    cen = centralized(ds, device=dev)
    print(f"centralized Pegasos   acc={float(obj.accuracy(cen.w, Xte, yte)):.3f}")

    res = gadget(ds, device=dev)
    acc = float(obj.accuracy(res.w_consensus, Xte, yte))
    print(f"GADGET (10 nodes)     acc={acc:.3f}  iters={res.iters} "
          f"eps_at_stop={res.epsilon:.2e}")

    W = res.W.cpu().numpy()
    spread = np.linalg.norm(W - W.mean(0), axis=1) / np.linalg.norm(W.mean(0))
    print(f"consensus: max relative node disagreement = {spread.max():.3%}")
    print("per-node accuracies:",
          [round(float(obj.accuracy(res.W[i], Xte, yte)), 3) for i in range(N_NODES)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
