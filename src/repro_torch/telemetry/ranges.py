"""Profiler ranges at the training loop's layer boundaries.

``with region("gadget.step"): ...`` opens a range named ``gadget.step`` on
the torch profiler's own clock while a torch profiler records, so the
program's host time lines up with the device trace by construction. With no
profiler recording, a region is one flag check and a context that does
nothing (``torch.autograd.profiler._is_profiler_enabled``, the flag the
profiler keeps for such checks).

A range is recorded as a CPU operation (``_RecordFunctionFast``), not as a
user annotation (``record_function``): the profiler mirrors a user
annotation onto the device timeline, where it would read as a device
operation. A region must not stay open across a ``yield``: a generator's
consumer would see its own work inside the range.
"""
from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["region"]


class _Off:
    """The context of a region while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


def region(name: str):
    """A profiler range named ``name`` around a ``with`` block while a torch
    profiler records; otherwise a context that does nothing."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _OFF
