"""Wrapper of the ``wkv_scan`` kernel (CUDA source: ``csrc/wkv_scan.cu``)
and its plain PyTorch version.

The wrapper calls the operator ``torch.ops.repro_torch.wkv_scan``, whose
implementation the dispatcher picks by the inputs' dispatch key: on CUDA
tensors the kernel's launch (after checks of dtype, shape and contiguity),
on CPU tensors the plain version; ``meta`` and fake tensors take the fake
implementation (shapes only); a real tensor on any other device raises. A
launch adds one to ``wkv_scan.launches``, and nothing else does. The
reference has no backward kernel (XLA differentiates its plain scan), so
the backward is an operator of its own,
``torch.ops.repro_torch.wkv_scan_backward``, the plain version's
vector-Jacobian product written out (the states recomputed, then the
reverse-time recurrence); each such pass on a CUDA device adds one to
``wkv_scan.plain_backwards``. Both operators carry a
FLOP formula and a DTensor sharding rule: replicated, batch-sharded (u
replicated; its gradient a partial sum), or head-sharded with u sharded on
its heads to match. A trace under ``FakeTensorMode`` or a sharded step
therefore never enters the plain loop.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import scan_ref

__all__ = ["MAX_HEAD_SIZE", "wkv_scan", "wkv_scan_plain", "wkv_scan_backward_plain"]

MAX_HEAD_SIZE = 256  # the kernel's largest n (a lane holds at most 32 rows of 4 columns)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv_scan.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


def wkv_scan_plain(r, k, v, w, u) -> torch.Tensor:
    """Plain PyTorch version: the recurrence one time step at a time, S_0 = 0."""
    return scan_ref(r, k, v, w, u)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, S, H, n) float32; u: (H, n). Returns out (B, S, H, n)
    with ``out_t = r_t (S + diag(u) k_tᵀ v_t)`` and
    ``S <- diag(w_t) S + k_tᵀ v_t`` per (batch, head), S_0 = 0. On CUDA, n
    must be at most ``MAX_HEAD_SIZE``."""
    return torch.ops.repro_torch.wkv_scan(r, k, v, w, u)


def wkv_scan_backward_plain(r, k, v, w, u, d_out) -> tuple:
    """(dr, dk, dv, dw, du): the vector-Jacobian product of the plain version
    at the inputs with ``d_out``, written out as the reverse-time
    recurrence. With S_{t-1} the state before step t (the forward recomputed
    and kept), kv_t = k_t ⊗ v_t and D the adjoint of S_t (0 after the last
    step), step t backwards gives
    dr_t = (S_{t-1} + u ⊙ kv_t) do_t, du += r_t ⊙ (kv_t do_t),
    dkv_t = D + (u ⊙ r_t) ⊗ do_t (so dk_t = dkv_t v_t, dv_t = dkv_tᵀ k_t),
    dw_t = Σ_j D ⊙ S_{t-1}, and D ← w_t ⊙ D + r_t ⊗ do_t. At S = 1 the decay
    reaches no output and its gradient is zero."""
    B, T, H, n = r.shape
    S = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    states = []
    for t in range(T):
        states.append(S)
        S = w[:, t][..., None] * S + k[:, t][..., :, None] * v[:, t][..., None, :]
    D = torch.zeros_like(S)
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.zeros_like(u)
    for t in range(T - 1, -1, -1):
        r_t, k_t, v_t, w_t, do = r[:, t], k[:, t], v[:, t], w[:, t], d_out[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]                   # (B, H, n, n)
        kv_do = torch.einsum("bhij,bhj->bhi", kv, do)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", states[t], do) + u * kv_do
        du += torch.sum(r_t * kv_do, dim=0)
        dkv = D + (u * r_t)[..., :, None] * do[..., None, :]
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dkv, v_t)
        dv[:, t] = torch.einsum("bhij,bhi->bhj", dkv, k_t)
        dw[:, t] = torch.sum(D * states[t], dim=-1)
        D = w_t[..., None] * D + r_t[..., :, None] * do[..., None, :]
    return dr, dk, dv, dw, du


@torch.library.custom_op("repro_torch::wkv_scan", mutates_args=(), device_types="cpu")
def _op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    _build.same_device(r, k, v, w, u)
    return wkv_scan_plain(r, k, v, w, u)


@_op.register_kernel("cuda")
def _(r, k, v, w, u):
    return _launch(r, k, v, w, u)


@_op.register_fake
def _(r, k, v, w, u):
    _build.same_device(r, k, v, w, u)
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)) or u.shape != r.shape[2:]:
        raise ValueError(f"r, k, v, w must be one (B, S, H, n) shape and u (H, n); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w, u)]}")
    return r.new_empty(r.shape)


@torch.library.custom_op("repro_torch::wkv_scan_backward", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, d_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                                torch.Tensor, torch.Tensor,
                                                                torch.Tensor]:
    grads = wkv_scan_backward_plain(r, k, v, w, u, d_out)
    if r.device.type == "cuda":
        wkv_scan.plain_backwards += 1
    return grads


@_backward_op.register_fake
def _(r, k, v, w, u, d_out):
    return tuple(t.new_empty(t.shape) for t in (r, k, v, w, u))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, d_out):
    return torch.ops.repro_torch.wkv_scan_backward(*ctx.saved_tensors, d_out)


_op.register_autograd(_backward, setup_context=_setup_context)


def _flops(r_shape) -> int:
    """The least flops of the forward (``ops.launch_cost``): 5·n² + 5·n a
    step, batch and head."""
    b, s, h, n = r_shape
    return b * s * h * (5 * n * n + 5 * n)


def _register() -> None:
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.wkv_scan)
    def _(r_shape, *args, out_shape=None, **kwargs) -> int:
        return _flops(r_shape)

    @register_flop_formula(torch.ops.repro_torch.wkv_scan_backward)
    def _(r_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * _flops(r_shape)  # the usual rule: a backward costs twice its forward

    @register_sharding(torch.ops.repro_torch.wkv_scan.default)
    def _(r, k, v, w, u):
        return [([Replicate()], [Replicate()] * 5),
                ([Shard(0)], [Shard(0)] * 4 + [Replicate()]),
                ([Shard(2)], [Shard(2)] * 4 + [Shard(0)])]

    @register_sharding(torch.ops.repro_torch.wkv_scan_backward.default)
    def _(r, k, v, w, u, d_out):
        return [([Replicate()] * 5, [Replicate()] * 6),
                ([Shard(0)] * 4 + [Partial()], [Shard(0)] * 4 + [Replicate(), Shard(0)]),
                ([Shard(2)] * 4 + [Shard(0)], [Shard(2)] * 4 + [Shard(0), Shard(2)])]


_register()


def _launch(r, k, v, w, u) -> torch.Tensor:
    """The kernel's launch on CUDA tensors, after the checks."""
    if r.ndim != 4:
        raise ValueError(f"r must be (B, S, H, n), got shape {tuple(r.shape)}")
    B, S, H, n = r.shape
    if not 1 <= n <= MAX_HEAD_SIZE:
        raise ValueError(f"head size {n} outside the kernel's 1..{MAX_HEAD_SIZE}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.check_tensor(name, t, (B, S, H, n))
    _build.check_tensor("u", u, (H, n))
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        code = _build.load(_SOURCE, _SIGNATURES).wkv_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            out.data_ptr(), B, S, H, n, _build.stream(r))
    _build.check(code, "wkv_scan")
    wkv_scan.launches += 1
    return out


wkv_scan.launches = 0
wkv_scan.plain_backwards = 0
