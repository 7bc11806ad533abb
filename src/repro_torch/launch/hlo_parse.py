"""Collective accounting for the dry-run, named after the reference's
``repro.launch.hlo_parse`` so the two packages' file lists line up. The
port emits no HLO: nothing here parses text. It keeps the reference's
ring-algorithm conventions and records the collectives a traced step
issues, under XLA's op names.

Convention (the reference's): bytes a device moves, from the per-device
output shape O and the group size g —
  all-gather: (g-1)/g * O;  reduce-scatter: (g-1) * O (input is g*O);
  all-reduce: 2*(g-1)/g * O;  all-to-all: (g-1)/g * O;
  collective-permute: O.

:class:`CollectiveRecorder` is told of each collective by the dry-run's
dispatch counter (the ``_c10d_functional`` ops DTensor issues when it
redistributes) and by ``core.mesh.Mesh.ppermute`` (the gossip's
point-to-point shares), and returns the reference's record,
``{"bytes_by_op", "count_by_op", "total_bytes"}``.
"""
from __future__ import annotations

__all__ = ["moved_bytes", "CollectiveRecorder", "FUNCTIONAL_OPS"]

# torch.ops._c10d_functional op name -> XLA's name
FUNCTIONAL_OPS = {"all_gather_into_tensor": "all-gather",
                  "reduce_scatter_tensor": "reduce-scatter",
                  "all_reduce": "all-reduce",
                  "all_to_all_single": "all-to-all"}


def moved_bytes(op: str, out_bytes: float, g: int) -> float:
    """Bytes one device moves for a collective of XLA kind ``op`` whose
    per-device output is ``out_bytes``, over a group of ``g``."""
    if op == "all-gather":
        return out_bytes * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) / max(g, 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / max(g, 1)
    if op == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {op!r}")


class CollectiveRecorder:
    """Bytes and counts of the collectives one device takes part in."""

    def __init__(self):
        self.bytes_by_op: dict[str, float] = {}
        self.count_by_op: dict[str, int] = {}

    def record(self, op: str, out_bytes: float, group_size: int) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + moved_bytes(op, out_bytes,
                                                                           group_size)
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1

    def summary(self) -> dict:
        return {"bytes_by_op": dict(self.bytes_by_op), "count_by_op": dict(self.count_by_op),
                "total_bytes": sum(self.bytes_by_op.values())}
