"""Wrapper of the ``rglru_scan`` kernel (CUDA source: ``csrc/rglru_scan.cu``)
and its plain PyTorch version.

The wrapper calls the operator ``torch.ops.repro_torch.rglru_scan``, whose
implementation the dispatcher picks by the inputs' dispatch key: on CUDA
tensors the kernel's launch (after checks of dtype, shape and contiguity),
on CPU tensors the plain version; ``meta`` and fake tensors take the fake
implementation (shapes only); a real tensor on any other device raises. A
launch adds one to ``rglru_scan.launches``, and nothing else does. The
operator carries a FLOP formula and a DTensor sharding rule: replicated, or
sharded on the batch or on the channel D (never on time). The kernel stages a and b in shared memory with
``cp.async``; :func:`copy_width` picks its copies' width.

The backward is the same recurrence run backwards in time
(:func:`rglru_scan_backward`): the adjoint g of h_t = a_t h_{t-1} + b_t is
g_t = dh_t + a_{t+1} g_{t+1}, with db = g and da_t = g_t h_{t-1}
(h_{-1} = 0), so one more call of the same operator on the time-flipped
inputs computes it: the kernel on CUDA, the plain scan on the CPU, shapes
under fake tensors, local shards on a mesh.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import copy_width
from repro_torch.kernels.rglru_scan.ref import scan_ref

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_scan_backward", "copy_width"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_scan": [_P, _P, _P, _I, _I, _I, _I, _P]}


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sequential recurrence, one step at a time."""
    return scan_ref(a, b)


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                        scan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of h = scan(a, b) given the output h and its cotangent dh,
    all (B, S, D): the reverse recurrence g_t = dh_t + a_{t+1} g_{t+1}
    (a_S = 0) as one forward ``scan`` (the operator by default) on the
    time-flipped inputs; db = g, da_t = g_t h_{t-1} with h_{-1} = 0."""
    scan = rglru_scan if scan is None else scan
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = _flip_time(scan(_flip_time(a_next), _flip_time(dh).contiguous()))
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, D) float32 -> h: (B, S, D) with h_t = a_t h_{t-1} + b_t,
    h_{-1} = 0, each step a multiply then an add, as the plain version."""
    return torch.ops.repro_torch.rglru_scan(a, b)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(), device_types="cpu")
def _op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _build.same_device(a, b)
    return rglru_scan_plain(a, b)


@_op.register_kernel("cuda")
def _(a, b):
    return _launch(a, b)


@_op.register_fake
def _(a, b):
    _build.same_device(a, b)
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be one (B, S, D) shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    return a.new_empty(a.shape)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, dh):
    a, h = ctx.saved_tensors
    from torch.distributed.tensor import DTensor
    if isinstance(h, DTensor):  # a and dh in h's placements, which keep time whole
        a, dh = (x if tuple(x.placements) == tuple(h.placements)
                 else x.redistribute(h.device_mesh, h.placements) for x in (a, dh))
    return rglru_scan_backward(a, h, dh)


def _flip_time(x: torch.Tensor) -> torch.Tensor:
    """``x`` reversed along time (dim 1); a DTensor's shards each flip their
    own rows (the scan's sharding rule never splits time)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return DTensor.from_local(torch.flip(x.to_local(), (1,)), x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape, stride=x.stride())
    return torch.flip(x, (1,))


_op.register_autograd(_backward, setup_context=_setup_context)


def _register() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.rglru_scan)
    def _(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
        n = a_shape[0] * a_shape[1] * a_shape[2]
        return 2 * n  # a multiply and an add an element

    @register_sharding(torch.ops.repro_torch.rglru_scan.default)
    def _(a, b):
        return [([p], [p, p]) for p in (Replicate(), Shard(0), Shard(2))]


_register()


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, after the checks."""
    if a.ndim != 3:
        raise ValueError(f"a must be (B, S, D), got shape {tuple(a.shape)}")
    B, S, D = a.shape
    _build.check_tensor("a", a, (B, S, D))
    _build.check_tensor("b", b, (B, S, D))
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = _build.load(_SOURCE, _SIGNATURES).rglru_scan(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
            copy_width(D, a.data_ptr(), b.data_ptr()), _build.stream(a))
    _build.check(code, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
