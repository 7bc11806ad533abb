"""Wrappers of the sparse (padded-ELL) Pegasos kernels: the sweep pair
``ell_margins`` and ``ell_grad_update`` and the touched-block pair
``ell_margins_prefetch`` and ``ell_grad_update_prefetch``, each margins
kernel also with the violator coefficients (``ell_margins_coeff``,
``ell_margins_prefetch_coeff``) and the touched-block grad also folded into
W as ``ell_grad_update_prefetch_fold``; and ``ell_grad_update_fused``, the
whole touched-block half-step (map, margins, coefficients and fold) in one
launch (CUDA source: ``csrc/sparse.cu``).

The minibatch is two (m, B, k) planes, ``cols`` int32 and ``vals`` float32,
with pad entries (col=0, val=0) and pad rows y=0, both inert. ``W`` is the
(m, d) weight plane as it is: the TPU kernels padded d to a block multiple
and appended a zero block for the prefetch map's sentinel to land on; these
kernels skip sentinel slots without reading W, so neither pad exists here.
An entry whose column lies outside [0, d) adds nothing.

The prefetch pair takes ``block_ids`` (m, n_blocks_max) int32, each row a
node's live d-block ids (blocks of ``blk_d`` columns) followed by the
sentinel ``n_d_blocks``; :func:`ell_block_map` builds it on the device. An
entry counts only when its block is in its node's row, as on the TPU: with
a sound cap that is every live entry, with an undersized cap the dropped
blocks' entries are lost.

Each function takes its plain PyTorch version (``*_plain``) for tensors on
the CPU, and launches its CUDA kernel for tensors on a CUDA device after
checking device, dtype, shape and contiguity; anything else raises. A
launch adds one to the wrapper's ``launches`` attribute, and nothing else
does. ``scal`` is ``(λα, α/B)`` as in ``hinge_subgrad.py``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hinge_subgrad.hinge_subgrad import _MAX_NODES, _f32_pair, _one_minus

__all__ = ["ell_margins", "ell_margins_coeff", "ell_grad_update", "ell_margins_prefetch",
           "ell_margins_prefetch_coeff", "ell_grad_update_prefetch",
           "ell_grad_update_prefetch_fold", "ell_margins_plain", "ell_margins_coeff_plain",
           "ell_grad_update_plain", "ell_margins_prefetch_plain",
           "ell_margins_prefetch_coeff_plain",
           "ell_grad_update_prefetch_plain", "ell_grad_update_prefetch_fold_plain",
           "ell_grad_update_fused", "fused_grid", "fused_tiles_per_block", "fold_buckets",
           "ell_block_map", "MAX_BLK_D"]

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sparse.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ell_margins": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ell_margins_coeff": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ell_margins_prefetch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "ell_margins_prefetch_coeff": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "ell_grad_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "ell_grad_update_prefetch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ell_grad_update_prefetch_fold": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                      _F, _F, _P],
    "ell_grad_update_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "ell_grad_update_fused_shape": [_I, _I, _I, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)],
}
MAX_BLK_D = 1024           # a prefetch block's lanes: its 256 threads own 4 each
_MAX_BITMAP_BYTES = 227 * 1024


def _lib() -> ctypes.CDLL:
    return _build.load(_SOURCE, _SIGNATURES)


def _check_planes(cols, vals) -> tuple[int, int, int]:
    m, B, k = cols.shape
    _build.check_tensor("cols", cols, (m, B, k), torch.int32)
    _build.check_tensor("vals", vals, (m, B, k))
    if not 1 <= m <= _MAX_NODES:
        raise ValueError(f"the sparse kernels take 1 <= m <= {_MAX_NODES}, got m={m}")
    return m, B, k


def _check_blocks(block_ids, m: int, blk_d: int, n_d_blocks: int, d: int | None = None) -> int:
    n_blocks_max = block_ids.shape[1] if block_ids.ndim == 2 else -1
    _build.check_tensor("block_ids", block_ids, (m, n_blocks_max), torch.int32)
    if not 1 <= blk_d <= MAX_BLK_D:
        raise ValueError(f"blk_d must lie in [1, {MAX_BLK_D}], got {blk_d}")
    check_bitmap(n_d_blocks, d, blk_d)
    return n_blocks_max


def check_bitmap(n_d_blocks: int, d: int | None = None, blk_d: int = 1) -> None:
    """Raise unless a bitmap of ``n_d_blocks`` bits fits a block's shared
    memory and, given d, covers every d-block of blk_d columns below d (the
    kernels look up the block of any column below d)."""
    if n_d_blocks < 1 or (n_d_blocks + 31) // 32 * 4 > _MAX_BITMAP_BYTES:
        raise ValueError(f"n_d_blocks={n_d_blocks} out of range")
    if d is not None and n_d_blocks < -(-d // blk_d):
        raise ValueError(f"n_d_blocks={n_d_blocks} covers fewer than the {-(-d // blk_d)} "
                         f"blocks of {blk_d} columns in d={d}")


def _in_map(cols: torch.Tensor, block_ids: torch.Tensor, blk_d: int,
            n_d_blocks: int) -> torch.Tensor:
    """(m, B, k) bool: the entry's d-block is in its node's row of the map."""
    m = cols.shape[0]
    table = torch.zeros((m, n_d_blocks + 1), dtype=torch.bool, device=cols.device)
    table.scatter_(1, block_ids.long().clamp(0, n_d_blocks), True)
    table[:, n_d_blocks] = False  # the sentinel marks nothing
    blk = (cols.long() // blk_d).clamp(0, n_d_blocks).reshape(m, -1)
    return torch.gather(table, 1, blk).reshape(cols.shape)


def ell_block_map(cols: torch.Tensor, vals: torch.Tensor, *, blk_d: int,
                  n_d_blocks: int, n_blocks_max: int) -> torch.Tensor:
    """Compact per-node touched-block-id map, in plain PyTorch on the planes'
    device with no host sync: the twin of
    ``repro_torch.sparse.formats.block_map`` (also ``ops.ell_block_map``).

    cols/vals: (m, B, k) minibatch planes → (m, n_blocks_max) int32 with each
    node's distinct live d-block ids ascending, then the sentinel
    ``n_d_blocks``. Pad entries (val = 0) mark nothing.

    Caller contract: ``n_blocks_max`` must be ≥ the realized live count
    (``formats.minibatch_block_bound`` is sound for every drawable
    minibatch). An undersized cap silently drops the highest live ids, and
    the kernels then lose those blocks' entries, as in the reference; the
    host twin raises on the same input.
    """
    m = cols.shape[0]
    blk = torch.where(vals != 0, cols.long() // blk_d, n_d_blocks).reshape(m, -1)
    touched = torch.zeros((m, n_d_blocks + 1), dtype=torch.bool, device=cols.device)
    touched.scatter_(1, blk, True)  # column n_d_blocks collects the pads: dropped
    ids = torch.where(touched[:, :n_d_blocks],
                      torch.arange(n_d_blocks, dtype=torch.int32, device=cols.device),
                      n_d_blocks)
    ids = torch.sort(ids, dim=1).values.to(torch.int32)
    if n_d_blocks < n_blocks_max:  # fewer real blocks than map slots: all live
        pad = torch.full((m, n_blocks_max - n_d_blocks), n_d_blocks, dtype=torch.int32,
                         device=cols.device)
        return torch.cat([ids, pad], dim=1)
    return ids[:, :n_blocks_max].contiguous()



# ---------------------------------------------------------------- ell_margins

def ell_margins_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch margins y_b·Σ_e vals[b,e]·W[i, cols[b,e]] per node."""
    m, B, k = cols.shape
    w_at = torch.gather(W, 1, cols.reshape(m, B * k).long()).reshape(m, B, k)
    return y * (vals * w_at).sum(dim=-1)


def _check_margins(cols, vals, W, y) -> tuple[int, int, int, int]:
    m, B, k = _check_planes(cols, vals)
    d = W.shape[1] if W.ndim == 2 else -1
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("y", y, (m, B))
    return m, B, k, d


def ell_margins(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """y·(X w) per node over (m, B, k) ELL planes, every entry: W (m, d),
    y (m, B) → (m, B). With a sound map, bit for bit
    :func:`ell_margins_prefetch`'s margins (one kernel body)."""
    if _build.on_cpu(cols, vals, W, y):
        return ell_margins_plain(cols, vals, W, y)
    m, B, k, d = _check_margins(cols, vals, W, y)
    out = torch.empty((m, B), dtype=torch.float32, device=W.device)
    with torch.cuda.device(W.device):
        code = _lib().ell_margins(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                  y.data_ptr(), out.data_ptr(), m, B, k, d,
                                  _build.stream(W))
    _build.check(code, "ell_margins")
    ell_margins.launches += 1
    return out


ell_margins.launches = 0


def ell_margins_coeff_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                            y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: :func:`ell_margins_plain`, then the violator
    coefficients ``torch.where(margins < 1, y, 0)``."""
    margins = ell_margins_plain(cols, vals, W, y)
    return margins, torch.where(margins < 1.0, y, torch.zeros_like(y))


def ell_margins_coeff(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                      y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ell_margins` and the violator coefficients in one launch:
    ``(margins, coeff)``, both (m, B), coeff bit for bit
    ``torch.where(margins < 1, y, 0)`` of the margins written (a NaN margin
    and a pad row, y = 0, give 0). The sweep schedule's margins."""
    if _build.on_cpu(cols, vals, W, y):
        return ell_margins_coeff_plain(cols, vals, W, y)
    m, B, k, d = _check_margins(cols, vals, W, y)
    out = torch.empty((m, B), dtype=torch.float32, device=W.device)
    coeff = torch.empty((m, B), dtype=torch.float32, device=W.device)
    with torch.cuda.device(W.device):
        code = _lib().ell_margins_coeff(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                        y.data_ptr(), out.data_ptr(), coeff.data_ptr(), m, B, k,
                                        d, _build.stream(W))
    _build.check(code, "ell_margins_coeff")
    ell_margins_coeff.launches += 1
    return out, coeff


ell_margins_coeff.launches = 0


# ------------------------------------------------------- ell_margins_prefetch

def ell_margins_prefetch_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                               y: torch.Tensor, block_ids: torch.Tensor, *,
                               blk_d: int, n_d_blocks: int) -> torch.Tensor:
    """Plain PyTorch margins over the entries whose block is in the map."""
    kept = torch.where(_in_map(cols, block_ids, blk_d, n_d_blocks), vals,
                       torch.zeros_like(vals))
    return ell_margins_plain(cols, kept, W, y)


def _check_margins_prefetch(cols, vals, W, y, block_ids, blk_d: int,
                            n_d_blocks: int) -> tuple[int, int, int, int, int]:
    m, B, k, d = _check_margins(cols, vals, W, y)
    return m, B, k, d, _check_blocks(block_ids, m, blk_d, n_d_blocks, d)


def ell_margins_prefetch(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                         y: torch.Tensor, block_ids: torch.Tensor, *, blk_d: int,
                         n_d_blocks: int) -> torch.Tensor:
    """Touched-block margins: as :func:`ell_margins`, counting only the
    entries whose d-block ``col // blk_d`` is in the node's row of
    ``block_ids`` (m, n_blocks_max). Returns (m, B)."""
    if _build.on_cpu(cols, vals, W, y, block_ids):
        return ell_margins_prefetch_plain(cols, vals, W, y, block_ids, blk_d=blk_d,
                                          n_d_blocks=n_d_blocks)
    m, B, k, d, n_blocks_max = _check_margins_prefetch(cols, vals, W, y, block_ids, blk_d,
                                                       n_d_blocks)
    out = torch.empty((m, B), dtype=torch.float32, device=W.device)
    with torch.cuda.device(W.device):
        code = _lib().ell_margins_prefetch(
            cols.data_ptr(), vals.data_ptr(), W.data_ptr(), y.data_ptr(),
            block_ids.data_ptr(), out.data_ptr(), m, B, k, d, n_blocks_max, blk_d,
            n_d_blocks, _build.stream(W))
    _build.check(code, "ell_margins_prefetch")
    ell_margins_prefetch.launches += 1
    return out


ell_margins_prefetch.launches = 0


def ell_margins_prefetch_coeff_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                                     y: torch.Tensor, block_ids: torch.Tensor, *, blk_d: int,
                                     n_d_blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: :func:`ell_margins_prefetch_plain`, then the violator
    coefficients ``torch.where(margins < 1, y, 0)``."""
    margins = ell_margins_prefetch_plain(cols, vals, W, y, block_ids, blk_d=blk_d,
                                         n_d_blocks=n_d_blocks)
    return margins, torch.where(margins < 1.0, y, torch.zeros_like(y))


def ell_margins_prefetch_coeff(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                               y: torch.Tensor, block_ids: torch.Tensor, *, blk_d: int,
                               n_d_blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ell_margins_prefetch` and the violator coefficients in one
    launch: ``(margins, coeff)``, both (m, B), coeff bit for bit
    ``torch.where(margins < 1, y, 0)`` of the margins written (a NaN margin
    and a pad row, y = 0, give 0). The prefetch schedule's margins."""
    if _build.on_cpu(cols, vals, W, y, block_ids):
        return ell_margins_prefetch_coeff_plain(cols, vals, W, y, block_ids, blk_d=blk_d,
                                                n_d_blocks=n_d_blocks)
    m, B, k, d, n_blocks_max = _check_margins_prefetch(cols, vals, W, y, block_ids, blk_d,
                                                       n_d_blocks)
    out = torch.empty((m, B), dtype=torch.float32, device=W.device)
    coeff = torch.empty((m, B), dtype=torch.float32, device=W.device)
    with torch.cuda.device(W.device):
        code = _lib().ell_margins_prefetch_coeff(
            cols.data_ptr(), vals.data_ptr(), W.data_ptr(), y.data_ptr(),
            block_ids.data_ptr(), out.data_ptr(), coeff.data_ptr(), m, B, k, d, n_blocks_max,
            blk_d, n_d_blocks, _build.stream(W))
    _build.check(code, "ell_margins_prefetch_coeff")
    ell_margins_prefetch_coeff.launches += 1
    return out, coeff


ell_margins_prefetch_coeff.launches = 0


# ------------------------------------------------------------ ell_grad_update

def ell_grad_update_plain(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                          coeff: torch.Tensor, scal) -> torch.Tensor:
    """Plain PyTorch (1 − s0)·W + s1·scatter(coeff_b·vals → cols) per node."""
    s0, s1 = _f32_pair(scal)
    m, B, k = cols.shape
    g = torch.zeros_like(W).scatter_add_(
        1, cols.reshape(m, B * k).long(), (coeff[:, :, None] * vals).reshape(m, B * k))
    return _one_minus(s0) * W + s1 * g


def ell_grad_update(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                    coeff: torch.Tensor, scal, *, blk_d: int = 512) -> torch.Tensor:
    """W_half = (1 − s0)·W + s1·scatter(coeff_b·vals → cols) per node in one
    launch. coeff: (m, B) = 1[margin<1]·y. Returns (m, d). The sweep
    schedule's grad. ``blk_d`` is the reference's tile width (the one
    ``resolve_ell_schedule`` picks), checked to be at least 1, as the
    reference needs, but not a shape of the kernel: on CUDA a block owns
    1,024 columns, and each lane's sum runs in entry order whatever the
    tiling."""
    if blk_d < 1:
        raise ValueError(f"blk_d must be at least 1, got {blk_d}")
    if _build.on_cpu(cols, vals, W, coeff):
        return ell_grad_update_plain(cols, vals, W, coeff, scal)
    m, B, k = _check_planes(cols, vals)
    d = W.shape[1] if W.ndim == 2 else -1
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("coeff", coeff, (m, B))
    s0, s1 = _f32_pair(scal)
    out = torch.empty_like(W)
    with torch.cuda.device(W.device):
        code = _lib().ell_grad_update(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                      coeff.data_ptr(), out.data_ptr(), m, B, k, d,
                                      _build.copy_width(d, W.data_ptr(), out.data_ptr()),
                                      s0, s1, _build.stream(W))
    _build.check(code, "ell_grad_update")
    ell_grad_update.launches += 1
    return out


ell_grad_update.launches = 0


# --------------------------------------------------- ell_grad_update_prefetch

def ell_grad_update_prefetch_plain(cols: torch.Tensor, vals: torch.Tensor,
                                   coeff: torch.Tensor, block_ids: torch.Tensor, *,
                                   blk_d: int, n_d_blocks: int) -> torch.Tensor:
    """Plain PyTorch buckets: G[i, j, lane] = Σ coeff_b·vals[b,e] over the
    entries with cols[b,e] == block_ids[i,j]·blk_d + lane; sentinel buckets
    are zero."""
    m, B, k = cols.shape
    n_blocks_max = block_ids.shape[1]
    dev = cols.device
    # slot of each block in the node's map; blocks outside it go to a dump slot
    slot = torch.full((m, n_d_blocks + 1), n_blocks_max, dtype=torch.long, device=dev)
    slot.scatter_(1, block_ids.long().clamp(0, n_d_blocks),
                  torch.arange(n_blocks_max, device=dev).expand(m, -1).contiguous())
    slot[:, n_d_blocks] = n_blocks_max
    c = cols.reshape(m, B * k).long()
    blk = (c // blk_d).clamp(0, n_d_blocks)
    flat = torch.gather(slot, 1, blk) * blk_d + (c - blk * blk_d).clamp(0, blk_d - 1)
    G = torch.zeros((m, (n_blocks_max + 1) * blk_d), dtype=torch.float32, device=dev)
    G.scatter_add_(1, flat, (coeff[:, :, None] * vals).reshape(m, B * k))
    return G[:, :n_blocks_max * blk_d].reshape(m, n_blocks_max, blk_d)


def ell_grad_update_prefetch(cols: torch.Tensor, vals: torch.Tensor, coeff: torch.Tensor,
                             block_ids: torch.Tensor, *, blk_d: int,
                             n_d_blocks: int) -> torch.Tensor:
    """Touched-block scatter: the raw per-bucket sums G (m, n_blocks_max,
    blk_d), bucket j of node i holding Σ coeff_b·vals[b,e] over the entries
    in d-block ``block_ids[i, j]`` at lane ``cols − block_ids[i,j]·blk_d``;
    sentinel buckets are zero. The decay and the fold into W are the
    caller's (``ops.ell_fleet_half_step``)."""
    if _build.on_cpu(cols, vals, coeff, block_ids):
        return ell_grad_update_prefetch_plain(cols, vals, coeff, block_ids, blk_d=blk_d,
                                              n_d_blocks=n_d_blocks)
    m, B, k = _check_planes(cols, vals)
    _build.check_tensor("coeff", coeff, (m, B))
    n_blocks_max = _check_blocks(block_ids, m, blk_d, n_d_blocks)
    G = torch.empty((m, n_blocks_max, blk_d), dtype=torch.float32, device=cols.device)
    with torch.cuda.device(cols.device):
        code = _lib().ell_grad_update_prefetch(
            cols.data_ptr(), vals.data_ptr(), coeff.data_ptr(), block_ids.data_ptr(),
            G.data_ptr(), m, B, k, n_blocks_max, blk_d, n_d_blocks, _build.stream(cols))
    _build.check(code, "ell_grad_update_prefetch")
    ell_grad_update_prefetch.launches += 1
    return G


ell_grad_update_prefetch.launches = 0


# ---------------------------------------------- ell_grad_update_prefetch_fold

def fold_buckets(W: torch.Tensor, G: torch.Tensor, block_ids: torch.Tensor, blk_d: int,
                 one_minus_s0: float, s1: float) -> torch.Tensor:
    """(1 − s0)·W everywhere, plus s1·G at the live buckets' lanes: the fold
    of :func:`ell_grad_update_prefetch`'s buckets into W, in plain PyTorch.
    A lane at or past d (a sentinel bucket's, or the tail of the last
    block's; all zero in G) adds into a spill slot of its own after the
    (m, d) plane, which is never read. A node's live ids are distinct, so no
    two additions meet one address, and the sum does not depend on their
    order."""
    m, d = W.shape
    n = G.numel()
    lanes = block_ids.long()[:, :, None] * blk_d + torch.arange(blk_d, device=W.device)
    rows = torch.arange(m, device=W.device)[:, None, None] * d
    spill = torch.arange(m * d, m * d + n, device=W.device).view(G.shape)
    idx = torch.where(lanes < d, rows + lanes, spill).reshape(-1)
    out = torch.empty(m * d + n, dtype=torch.float32, device=W.device)
    torch.mul(W.reshape(-1), one_minus_s0, out=out[:m * d])
    out.index_add_(0, idx, (s1 * G).reshape(-1))
    return out[:m * d].view(m, d)


def ell_grad_update_prefetch_fold_plain(cols: torch.Tensor, vals: torch.Tensor,
                                        coeff: torch.Tensor, block_ids: torch.Tensor,
                                        W: torch.Tensor, scal, *, blk_d: int,
                                        n_d_blocks: int) -> torch.Tensor:
    """Plain PyTorch: the plain buckets, then :func:`fold_buckets`."""
    s0, s1 = _f32_pair(scal)
    G = ell_grad_update_prefetch_plain(cols, vals, coeff, block_ids, blk_d=blk_d,
                                       n_d_blocks=n_d_blocks)
    return fold_buckets(W, G, block_ids, blk_d, _one_minus(s0), s1)


def ell_grad_update_prefetch_fold(cols: torch.Tensor, vals: torch.Tensor, coeff: torch.Tensor,
                                  block_ids: torch.Tensor, W: torch.Tensor, scal, *,
                                  blk_d: int, n_d_blocks: int) -> torch.Tensor:
    """W_half = (1 − s0)·W + s1·G at the live buckets' lanes below d, in one
    launch, G as :func:`ell_grad_update_prefetch` sums it: bit for bit that
    entry followed by :func:`fold_buckets`. W: (m, d); ``scal`` = (λα, α/B).
    Returns (m, d)."""
    if _build.on_cpu(cols, vals, coeff, block_ids, W):
        return ell_grad_update_prefetch_fold_plain(cols, vals, coeff, block_ids, W, scal,
                                                   blk_d=blk_d, n_d_blocks=n_d_blocks)
    m, B, k = _check_planes(cols, vals)
    d = W.shape[1] if W.ndim == 2 else -1
    _build.check_tensor("W", W, (m, d))
    _build.check_tensor("coeff", coeff, (m, B))
    n_blocks_max = _check_blocks(block_ids, m, blk_d, n_d_blocks)
    s0, s1 = _f32_pair(scal)
    out = torch.empty_like(W)
    with torch.cuda.device(W.device):
        code = _lib().ell_grad_update_prefetch_fold(
            cols.data_ptr(), vals.data_ptr(), coeff.data_ptr(), block_ids.data_ptr(),
            W.data_ptr(), out.data_ptr(), m, B, k, d, n_blocks_max, blk_d, n_d_blocks, s0, s1,
            _build.stream(W))
    _build.check(code, "ell_grad_update_prefetch_fold")
    ell_grad_update_prefetch_fold.launches += 1
    return out


ell_grad_update_prefetch_fold.launches = 0


# ------------------------------------------------------ ell_grad_update_fused

def fused_grid(m: int, tiles: int, resident: int) -> int:
    """The run of tiles each block of :func:`ell_grad_update_fused` folds,
    for m nodes of ``tiles`` tiles of W each when ``resident`` of its blocks
    fit on the card at once: about one wave, ``min(tiles, max(1, resident //
    m))`` blocks a node, the runs as even as whole tiles allow (the kernel
    launches ⌈tiles / run⌉ blocks a node). At CCAT's d (47 tiles) a block
    folds one tile; at kdda's (19,743), with an H100's 660 resident blocks,
    300."""
    return -(-tiles // min(tiles, max(1, resident // max(m, 1))))


@functools.lru_cache(maxsize=None)
def _fused_shape(device_index: int, B: int, d: int, n_d_blocks: int) -> tuple[int, int]:
    """(tiles of a row of d, blocks of the fused kernel the card holds at
    once at this shape's shared memory, 0 where a block cannot hold it), as
    the C entry reports them; one query per shape."""
    tiles, resident = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _lib().ell_grad_update_fused_shape(B, d, n_d_blocks, ctypes.byref(tiles),
                                                  ctypes.byref(resident))
    _build.check(code, "ell_grad_update_fused_shape")
    return tiles.value, resident.value


def fused_tiles_per_block(m: int, B: int, d: int, n_d_blocks: int, device) -> int:
    """The run of tiles a block of :func:`ell_grad_update_fused` folds at
    this shape on ``device``: :func:`fused_grid` of what the card reports;
    0 on the CPU, where no kernel runs. Raises ``ValueError`` where the
    bitmaps of the d-blocks and of the tiles and the B coefficients do not
    fit a block's shared memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    index = device.index if device.index is not None else torch.cuda.current_device()
    tiles, resident = _fused_shape(index, B, d, n_d_blocks)
    if resident == 0:
        raise ValueError(f"the bitmaps of {n_d_blocks} blocks and of the tiles of d={d} and "
                         f"B={B} coefficients exceed a block's shared memory")
    return fused_grid(m, tiles, resident)


def ell_grad_update_fused(cols: torch.Tensor, vals: torch.Tensor, W: torch.Tensor,
                          y: torch.Tensor, scal, *, blk_d: int, n_d_blocks: int,
                          n_blocks_max: int) -> torch.Tensor:
    """The touched-block half-step in one launch: the node's map of its
    ``n_blocks_max`` lowest live d-blocks (of ``blk_d`` columns), the margins
    and violator coefficients over the entries in the map, and W_half =
    (1 − s0)·W + s1·their scatter at the map's lanes. W: (m, d), y: (m, B),
    ``scal`` = (λα, α/B). Returns W_half (m, d), bit for bit
    :func:`ell_block_map`, :func:`ell_margins_prefetch_coeff` and
    :func:`ell_grad_update_prefetch_fold` in turn, which is what it runs on
    the CPU. The bitmap of the d-blocks, one bit per tile of W and the B
    coefficients share a block's shared memory, which bounds B (about
    54,000 rows at CCAT's d).

    The grid is :func:`fused_tiles_per_block`'s: about one wave of the
    blocks the card holds at once at this shape (the occupancy query, once
    per shape). A block builds its node's map, margins and coefficients
    once, then folds a run of tiles of W's 1,024 columns, skipping the
    scatter of a tile no entry falls in. So the map's cost is per block, not
    per tile. At CCAT (47 tiles a node, ten nodes) each block folds one
    tile, and the launch bounds the call; at kdda (19,743 tiles a node)
    each folds about 300, and the stream of W in and W_half out bounds it.
    The last launch's run is kept as ``ell_grad_update_fused.tiles_per_block``
    (0 before the first launch)."""
    if _build.on_cpu(cols, vals, W, y):
        bids = ell_block_map(cols, vals, blk_d=blk_d, n_d_blocks=n_d_blocks,
                             n_blocks_max=n_blocks_max)
        _, coeff = ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=blk_d,
                                              n_d_blocks=n_d_blocks)
        return ell_grad_update_prefetch_fold(cols, vals, coeff, bids, W, scal, blk_d=blk_d,
                                             n_d_blocks=n_d_blocks)
    m, B, k, d = _check_margins(cols, vals, W, y)
    if B < 1 or k < 1:
        raise ValueError(f"ell_grad_update_fused takes B >= 1 and k >= 1, got B={B}, k={k}")
    if not 1 <= blk_d <= MAX_BLK_D:
        raise ValueError(f"blk_d must lie in [1, {MAX_BLK_D}], got {blk_d}")
    if n_blocks_max < 1:
        raise ValueError(f"n_blocks_max must be at least 1, got {n_blocks_max}")
    check_bitmap(n_d_blocks, d, blk_d)
    s0, s1 = _f32_pair(scal)
    tiles_per_block = fused_tiles_per_block(m, B, d, n_d_blocks, W.device)
    out = torch.empty_like(W)
    with torch.cuda.device(W.device):
        code = _lib().ell_grad_update_fused(
            cols.data_ptr(), vals.data_ptr(), W.data_ptr(), y.data_ptr(), out.data_ptr(), m, B,
            k, d, min(n_blocks_max, n_d_blocks), blk_d, n_d_blocks, tiles_per_block, s0, s1,
            _build.stream(W))
    _build.check(code, "ell_grad_update_fused")
    ell_grad_update_fused.launches += 1
    ell_grad_update_fused.tiles_per_block = tiles_per_block
    return out


ell_grad_update_fused.launches = 0
ell_grad_update_fused.tiles_per_block = 0
