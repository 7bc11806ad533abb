"""Faults planted in the program, to show that the comparison catches them.

Each is a context manager that patches the program's training step while it
is open: ``unchanged`` (a step that returns its state unchanged),
``half_batch`` (the half-step sees half of each minibatch and takes the mean
over those rows), ``no_mix`` (the exchange between nodes left out: each
node keeps its own half-step) and ``altered`` (the answer altered where it
is produced: the consensus 1% off, as a wrong normalisation would leave it).
A cell can have ``half_batch`` only where its minibatch has two rows or
more (``applies``).
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_mix", "altered")


def applies(name: str, traffic: dict) -> bool:
    """Whether a cell with this traffic mix can have fault ``name``."""
    return name != "half_batch" or traffic["batch_size"] >= 2


@contextlib.contextmanager
def planted(name: str):
    """Patch the program with fault ``name`` inside the block."""
    from repro_torch.core import gadget
    ops = gadget.ops
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(gadget._Run, "_step", lambda self, ids, W, Bs, t: (W, self.counts_f.clone()))
    elif name == "half_batch":
        dense, ell = ops.fleet_half_step, ops.ell_fleet_half_step

        def half_dense(W, X, y, *, row_mask=None, **kw):
            h = X.shape[1] // 2
            return dense(W, X[:, :h].contiguous(), y[:, :h].contiguous(),
                         row_mask=None if row_mask is None else row_mask[:h], **kw)

        def half_ell(W, cols, vals, y, **kw):
            h = cols.shape[1] // 2
            return ell(W, cols[:, :h].contiguous(), vals[:, :h].contiguous(),
                       y[:, :h].contiguous(), **kw)

        patch(ops, "fleet_half_step", half_dense)
        patch(ops, "ell_fleet_half_step", half_ell)
    elif name == "no_mix":
        patch(gadget, "mix_collapsed", lambda values, weight, P: (values, weight))
    elif name == "altered":
        consensus = gadget._Run.consensus_of
        patch(gadget._Run, "consensus_of", lambda self, W: 1.01 * consensus(self, W))
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
