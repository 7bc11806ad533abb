"""Node failures during gossip — the paper's §5 future-work scenario, live,
on the PyTorch/CUDA port.

Trains GADGET while links drop 20% of messages (ack'd fail-stop model) and
with two nodes crashed outright, and shows the surviving network still
converges — the Push-Sum mass bookkeeping is doing the fault tolerance.

The twin of ``examples/fault_tolerant_gossip.py`` on ``repro_torch``: the
same loop over ``FaultySim``, whose weights and rounds live on the values'
device (the CUDA card unless ``--device cpu``). The minibatch ids are the
reference's key chain (``split`` then ``randint``, JAX's Threefry streams
through ``core.counter_rng``), so a run is the reference's run of the same
seed to float rounding. The half-step is plain PyTorch under ``torch.vmap``,
as the reference's is a plain ``vmap``.

  PYTHONPATH=src python examples/torch_fault_tolerant_gossip.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import counter_rng as crng
from repro_torch.core import svm_objective as obj
from repro_torch.core.resilience import FaultySim
from repro_torch.data.svm_datasets import make_dataset, partition

N_NODES, SCALE = 10, 0.4


def gadget_with_faults(Xp, yp, lam, sim: FaultySim, n_iters=1200, batch=8, seed=0):
    """GADGET loop re-implemented over the faulty simulator (host loop,
    fine at example scale). ``Xp`` (m, n_i, d) and ``yp`` (m, n_i) are
    tensors; the result is (m, d) on their device."""
    m, n_i, d = Xp.shape
    W = torch.zeros((m, d), dtype=torch.float32, device=Xp.device)
    flat = torch.arange(m * batch, dtype=torch.int64, device=Xp.device).view(m, batch)
    key = crng.prng_key(seed)
    for t in range(1, n_iters + 1):
        key, sub = crng.fold_in(key, 0), crng.fold_in(key, 1)  # jax.random.split(key)
        ids = crng.randint(sub, flat, n_i)
        alpha = 1.0 / (lam * t)

        def half(w, Xi, yi, ii):
            Xb, yb = Xi[ii], yi[ii]
            L = -obj.hinge_subgradient(w, Xb, yb)
            return obj.project_ball((1 - lam * alpha) * w + alpha * L, lam)

        W = torch.vmap(half)(W, Xp, yp, ids)
        st = sim.init((W,))
        for r in range(3):
            st = sim.round(st, t * 3 + r)
        W = st.estimate()[0]
    return W


def cases():
    """The three networks of the example: (name, simulator)."""
    return [
        ("clean", FaultySim(N_NODES, "random", drop_prob=0.0, seed=1)),
        ("20% link drops", FaultySim(N_NODES, "random", drop_prob=0.2, drop="link", seed=1)),
        ("2 dead nodes", FaultySim(N_NODES, "random", dead_nodes=(2, 5), seed=1)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_dataset("usps", scale=SCALE, seed=0)
    Xte = torch.from_numpy(ds.X_test).to(dev)
    yte = torch.from_numpy(ds.y_test).to(dev)
    Xp, yp, _nc = partition(ds.X_train, ds.y_train, N_NODES)
    Xp, yp = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)

    for name, sim in cases():
        W = gadget_with_faults(Xp, yp, ds.lam, sim)
        accs = [float(obj.accuracy(W[i], Xte, yte)) for i in range(N_NODES)]
        alive = [a for i, a in enumerate(accs) if i not in getattr(sim, "dead", ())]
        print(f"{name:16s}: node-acc mean {np.mean(alive):.3f} "
              f"(min {min(alive):.3f}, max {max(alive):.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
