"""The comparison that decides ``correct``.

The program trains from the seed; the reference (``reference.py``) follows
it. Two stages are checked, each one segment of iterations long:

* ``start``: the first segment, from zero weights, which set-up drives
  through the stream that the window then continues;
* ``end``: the last segment of the window, from the program's own state at
  its start (the reference cannot afford the whole window; the stages in
  between run the same code as this one).

For a stage the numbers are, as for any training step: the gap between
the program's and the reference's norm of each node's change of W, and of
W_sum, over the stage, taken at the worst node against the reference's norm
of that node or of the median node, whichever is larger (``*_dw``,
``*_dsum``); and the relative gap of the primal objective of the consensus
(``*_obj``). After the end stage the consensus is judged as an answer: its
test scores against the reference consensus's, the largest difference over
the largest reference score (``scores``), and the worst node's distance of
W from the reference's (``end_w``). Nodes whose reference change is under
a thousandth of the median node's are left out of the change numbers.

A cell's ``workloads/<cell>.json`` names the numbers it compares, with
their limits and the readings each limit was set from; the others are
printed, not compared. A violator flips (margin 1 crossed) on rounding
alone now and then, and a flip moves one node by alpha_t/B, so a number
taken at one node or one test row can read far above its usual size on a
seed where one happens, with the reference against itself as much.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench import reference as ref


class Stage(NamedTuple):
    """A checked stage: the state ``(W, W_sum)`` before iteration ``t0``, and
    the candidate's state after ``n`` iterations with its objective."""

    t0: int
    n: int
    W0: torch.Tensor
    S0: torch.Tensor
    W1: torch.Tensor
    S1: torch.Tensor
    objective: float


def change_gaps(before: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each node's gap between the norms of the two changes, against the
    larger of that node's and the median node's reference change; nodes
    whose reference change is under a thousandth of the median's are left
    out."""
    dg = torch.linalg.vector_norm((got - before).double(), dim=1)
    dw = torch.linalg.vector_norm((want - before).double(), dim=1)
    med = dw.median()
    keep = dw >= 1e-3 * med
    return ((dg - dw).abs() / torch.clamp(dw, min=med))[keep]


def distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst node's distance from the reference, against the larger of its
    own and the median node's norm."""
    diff = torch.linalg.vector_norm((got - want).double(), dim=1)
    norm = torch.linalg.vector_norm(want.double(), dim=1)
    return float((diff / torch.clamp(norm, min=norm.median()).clamp(min=1e-30)).max())


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def stage_numbers(name: str, fleet: ref.Fleet, s: ref.Settings,
                  st: Stage) -> tuple[dict, torch.Tensor]:
    """The stage's numbers, and the reference's W after it."""
    W, S = ref.segment(fleet, s, st.W0, st.S0, st.t0, st.n)
    want_obj = ref.objective(fleet, ref.consensus(fleet, W), s.lam)
    dw, dsum = change_gaps(st.W0, st.W1, W), change_gaps(st.S0, st.S1, S)
    return {f"{name}_dw": float(dw.max()), f"{name}_dsum": float(dsum.max()),
            f"{name}_obj": rel(st.objective, want_obj)}, W


def answer_numbers(fleet: ref.Fleet, test, w_got: torch.Tensor, scores_got: torch.Tensor,
                   W_got: torch.Tensor, W_want: torch.Tensor) -> dict:
    """The consensus's test scores and the final W against the reference's."""
    want = ref.scores(ref.consensus(fleet, W_want), test.X, test.cols, test.vals)
    return {"scores": float((scores_got.double() - want).abs().max() / want.abs().max()),
            "end_w": distance(W_got, W_want)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for every number compared, its value beside its
    limit. A number that is missing or not finite fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
