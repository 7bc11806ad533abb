"""Probes of two kernels' designs on one CUDA card: ``grad_update`` (the
fleet form) and ``ell_grad_update`` (the sweep grad).

Three parts, timed with ``chip_smoke.device_ms`` in one process:

* check: both kernels against their plain versions at the unfused reuters
  fleet (10, 1, 8315), one node, ragged fleets (B = 37, d % 4 != 0, a flat
  tail, d = 1) and an X view off the 16-byte grid; the sweep grad at a
  CCAT-like minibatch (10 nodes, B = 1, k = 76 distinct columns a row,
  d = 47,236, pad entries, a -0 in W) bit for bit, at every blk_d and
  from a W off the 16-byte grid, and at ragged shapes (rows sharing
  columns, an all-pad node, 12,000 entries a node); each rerun bit for bit,
  the fleet launch bit for bit the one-node launches stacked; and, with
  ``--parent`` (another checkout whose ``grad_update`` C entry takes one
  node and whose ``ell_grad_update`` takes blk_d: the first CUDA versions),
  the parent's kernels against the plain versions;
* floor: a launch doing nothing at each kernel's grid;
* variants: each kernel with one design choice undone, as a text edit of
  its source built under build/probes/, timed in turns beside the kernels
  as they are, the parent's (the per-node loop and its stack),
  ``torch.baddbmm``, ``torch.addmv`` and the prefetch path's fold entry.
  ``grad_update``: blocks of 128 threads (every SM a block at the fleet's
  shape), and B = 1 through the rows kernel (its loop over B). The sweep
  grad: 512-column tiles, and 4-byte copies.

Usage:
    python3 tools/kernel_probes.py [--parent CHECKOUT]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNELS = HERE / "src" / "repro_torch" / "kernels"
PROBES = HERE / "build" / "probes"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
GRAD_ARGS = [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P]
SWEEP_ARGS = [_P] * 5 + [_I] * 5 + [_F] * 2 + [_P]
PARENT_GRAD_ARGS = [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P]

FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_empty(float* out) { if (threadIdx.x == 0 && blockIdx.x == 0) out[blockIdx.y] = 0.f; }
// an empty kernel at a grid of (gx, gy) blocks of `threads`
extern "C" int probe(void* out, int gx, int gy, int threads, void* stream) {
  k_empty<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>((float*)out);
  return (int)cudaGetLastError();
}
"""

def variant(src: Path, name: str, edits: dict) -> Path:
    """``src`` with each of ``edits`` (old line -> new line) applied, and the
    headers beside it, under build/probes/<name>/."""
    text = src.read_text()
    for old, new in edits.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: {old!r} is not in the source once; update the probe")
        text = text.replace(old, new)
    out = PROBES / name
    out.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    (out / src.name).write_text(text)
    return out / src.name


def main() -> int:
    """Run the three parts; one JSON line at the end."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="checkout whose first kernels to time beside")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    from chip_smoke import device_ms, rel_err
    from repro_torch.kernels import _build
    from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import sparse as S

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sparse_src = KERNELS / "hinge_subgrad" / "csrc" / "sparse.cu"
    dense_src = KERNELS / "hinge_subgrad" / "csrc" / "hinge_subgrad.cu"
    sources = {"tile512": variant(sparse_src, "tile512", {
        "constexpr int kTileLanes = kThreads * 4;": "constexpr int kTileLanes = kThreads * 2;"}),
        "threads128": variant(dense_src, "threads128", {
            "constexpr int kGradThreads = kThreads;": "constexpr int kGradThreads = 128;"}),
        "rows_b1": variant(dense_src, "rows_b1", {"  if (B == 1)\n": "  if (false)\n"})}
    (PROBES / "floor").mkdir(parents=True, exist_ok=True)
    sources["floor"] = PROBES / "floor" / "probe.cu"
    sources["floor"].write_text(FLOOR_SOURCE)
    if args.parent is not None:
        pk = args.parent.resolve() / "src" / "repro_torch" / "kernels" / "hinge_subgrad" / "csrc"
        sources["parent_dense"] = pk / "hinge_subgrad.cu"
        sources["parent_sparse"] = pk / "sparse.cu"
    _build.build(list(sources.values()) + _build.all_sources())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out: dict = {"card": card}
    fails = []

    def check(ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            fails.append(what)

    def off_grid(t):
        """A copy of t whose data starts 4 bytes past a 16-byte boundary."""
        v = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        v.copy_(t)
        return v

    threads128 = _build.load(sources["threads128"], {"grad_update": GRAD_ARGS})
    rows_b1 = _build.load(sources["rows_b1"], {"grad_update": GRAD_ARGS})
    par_dense = par_sparse = None
    if args.parent is not None:
        par_dense = _build.load(sources["parent_dense"], {"grad_update": PARENT_GRAD_ARGS})
        par_sparse = _build.load(sources["parent_sparse"], {"ell_grad_update": SWEEP_ARGS})

    # ---------------------------------------------------------- grad_update
    def fleet(m, B, d):
        X = torch.randn(m, B, d, generator=gen, device=dev)
        X /= X.norm(dim=-1, keepdim=True)
        W = 10 * torch.randn(m, d, generator=gen, device=dev)
        c = torch.where(torch.rand(m, B, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        c[:, ::3] = 0.0
        return X, W, c, ops.step_scalars(1.29e-4, 1000, B)

    def stacked(X, W, c, s):
        return torch.stack([K.grad_update(X[i], W[i], c[i], s) for i in range(X.shape[0])])

    def c_grad(lib, X, W, c, s, res):
        """A grad_update C entry of this checkout's or of a variant's."""
        m, B, d = X.shape
        return lambda: lib.grad_update(X.data_ptr(), W.data_ptr(), c.data_ptr(), res.data_ptr(),
                                       m, B, d, s[0], s[1], stream)

    def parent_loop(X, W, c, s, res):
        """The parent's unfused step: one launch a node, then the stack."""
        m, B, d = X.shape
        outs = [res[i] for i in range(m)]

        def run():
            for i in range(m):
                par_dense.grad_update(X[i].data_ptr(), W[i].data_ptr(), c[i].data_ptr(),
                                      outs[i].data_ptr(), B, d, s[0], s[1], stream)
            return torch.stack(outs)
        return run

    main = None
    for m, B, d in ((10, 1, 8315), (1, 1, 8315), (3, 37, 1001), (2, 5, 8316), (4, 1, 3),
                    (3, 2, 1), (32, 1, 70001)):
        X, W, c, s = fleet(m, B, d)
        got, want = K.grad_update(X, W, c, s), K.grad_update_plain(X, W, c, s)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        check(err[1] <= 1e-5, f"grad_update ({m}, {B}, {d}): rel err {err[1]:.3e}, "
              f"bit for bit the plain version: {torch.equal(got, want)}")
        check(torch.equal(got, stacked(X, W, c, s)) and torch.equal(got, K.grad_update(X, W, c, s))
              and torch.equal(got, K.grad_update(off_grid(X), W, c, s)),
              f"grad_update ({m}, {B}, {d}): the one-node launches stacked, a rerun and an X off "
              "the 16-byte grid, bit for bit")
        res = torch.empty_like(W)
        runs = [("blocks of 128", c_grad(threads128, X, W, c, s, res)),
                ("the rows kernel", c_grad(rows_b1, X, W, c, s, res))]
        for tag, run in runs:
            res.fill_(float("nan"))
            code = run()
            torch.cuda.synchronize()
            check(code == 0 and torch.equal(res, got),
                  f"grad_update ({m}, {B}, {d}), {tag}: bit for bit")
        if par_dense is not None:
            res = torch.empty_like(W)
            par = parent_loop(X, W, c, s, res)()
            torch.cuda.synchronize()
            check(rel_err(par, want)[1] <= 1e-5, f"parent grad_update ({m}, {B}, {d}) agrees")
        if (m, B, d) == (10, 1, 8315):
            main = (X, W, c, s)
    X, W, c, s = main
    one_minus = float(np.float32(1) - np.float32(s[0]))
    X1, w1, c1 = (a[0].clone() for a in (X, W, c))
    res = torch.empty_like(W)
    floor = _build.load(sources["floor"], {"probe": [_P, _I, _I, _I, _P]})
    timed = {"fleet": lambda: K.grad_update(X, W, c, s),
             "one_node": lambda: K.grad_update(X1, w1, c1, s),
             "fleet_as_one_node_loop": lambda: stacked(X, W, c, s),
             "variant_threads128": c_grad(threads128, X, W, c, s, res),
             "variant_rows_kernel": c_grad(rows_b1, X, W, c, s, res),
             "baddbmm": lambda: torch.baddbmm(W[:, None, :], c[:, None, :], X, beta=one_minus,
                                              alpha=s[1]),
             "addmv_one_node": lambda: torch.addmv(w1, X1.t(), c1, beta=one_minus, alpha=s[1]),
             "floor_launch": lambda: floor.probe(res.data_ptr(), 33, 10, 256, stream)}
    if par_dense is not None:
        pres = torch.empty_like(W)
        timed["parent_loop"] = parent_loop(X, W, c, s, pres)
        timed["parent_one_node"] = lambda: par_dense.grad_update(
            X1.data_ptr(), w1.data_ptr(), c1.data_ptr(), pres.data_ptr(), 1, 8315, s[0], s[1],
            stream)
    us = {key: [] for key in timed}
    for rep in range(2):  # in turns, the order reversed the second time
        for key in (list(timed) if rep == 0 else list(timed)[::-1]):
            # 50 calls of the eleven-launch loops stay within the launch queue
            n = 50 if "loop" in key else 200
            us[key].append(device_ms(torch, timed[key], n) * 1e3)
    out["grad_update_us"] = us
    print("grad_update at (10, 1, 8315), grid (33, 10) x 256, us: "
          + ", ".join(f"{key} {v[0]:.3f} {v[1]:.3f}" for key, v in us.items()), flush=True)

    # ------------------------------------------------------ ell_grad_update
    tile512 = _build.load(sources["tile512"], {"ell_grad_update": SWEEP_ARGS})

    def ccat_like():
        m, B, k, d = 10, 1, 76, 47236
        u = torch.rand(m, 4 * k, generator=gen, device=dev)  # frequent columns first, as CCAT's
        cols = torch.stack([torch.unique((u[i] ** 3 * d).long())[:k] for i in range(m)])
        cols = cols[:, None].to(torch.int32).contiguous()
        vals = torch.rand(m, B, cols.shape[-1], generator=gen, device=dev)
        cols[..., -5:], vals[..., -5:] = 0, 0.0  # pad entries
        vals /= vals.norm(dim=-1, keepdim=True)
        W = 3 * torch.randn(m, d, generator=gen, device=dev)
        W[0, :7] = -0.0
        y = torch.where(torch.rand(m, B, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        coeff = torch.where(S.ell_margins_plain(cols, vals, W, y) < 1.0, y, torch.zeros_like(y))
        return cols, vals, W, coeff, ops.step_scalars(1e-4, 1000, B)

    def ragged(m, B, k, d, shared=False, pad_node=False):
        cols = torch.randint(0, d, (m, B, k), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand(m, B, k, generator=gen, device=dev)
        pad = torch.rand(m, B, k, generator=gen, device=dev) < 0.25
        cols[pad], vals[pad] = 0, 0.0
        if shared:
            cols[0, :, 0], vals[0, :, 0] = 17, 0.5
        if pad_node:
            cols[1], vals[1] = 0, 0.0
        W = 3 * torch.randn(m, d, generator=gen, device=dev)
        coeff = torch.randn(m, B, generator=gen, device=dev)
        return cols, vals, W, coeff, ops.step_scalars(1e-4, 1000, B)

    def c_sweep(lib, cols, vals, W, coeff, s, res, last):
        """An ell_grad_update C entry (``last``: this one's width, the parent's blk_d)."""
        m, B, k = cols.shape
        return lambda: lib.ell_grad_update(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                           coeff.data_ptr(), res.data_ptr(), m, B, k,
                                           W.shape[1], last, s[0], s[1], stream)

    cases = {"ccat_like": ccat_like(), "shared": ragged(3, 5, 13, 1001, shared=True),
             "pad_node": ragged(3, 5, 13, 1004, pad_node=True),
             "entries_12000": ragged(2, 40, 300, 3000, shared=True)}
    for name, (cols, vals, W, coeff, s) in cases.items():
        got = S.ell_grad_update(cols, vals, W, coeff, s)
        want = S.ell_grad_update_plain(cols, vals, W, coeff, s)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        check(torch.equal(got, want) if name == "ccat_like" else err[1] <= 1e-5,
              f"ell_grad_update {name} {tuple(cols.shape)}, d {W.shape[1]}: rel err {err[1]:.3e}, "
              f"bit for bit: {torch.equal(got, want)}")
        check(all(torch.equal(S.ell_grad_update(cols, vals, w_, coeff, s, blk_d=b_), got)
                  for w_, b_ in ((W, 128), (W, 1000), (off_grid(W), 512))),
              f"ell_grad_update {name}: every blk_d, a rerun and a W off the 16-byte grid, bit "
              "for bit")
        res = torch.empty_like(W)
        c_sweep(tile512, cols, vals, W, coeff, s, res, _build.copy_width(W.shape[1], W.data_ptr(),
                                                                         res.data_ptr()))()
        torch.cuda.synchronize()
        check(torch.equal(res, got), f"ell_grad_update {name}: 512-column tiles, bit for bit")
        if par_sparse is not None:
            c_sweep(par_sparse, cols, vals, W, coeff, s, res, 512)()
            torch.cuda.synchronize()
            check(rel_err(res, want)[1] <= 1e-5, f"parent ell_grad_update {name} agrees")
    cols, vals, W, coeff, s = cases["ccat_like"]
    m, B, k = cols.shape
    d = W.shape[1]
    res = torch.empty_like(W)
    W_off = off_grid(W)
    nd = -(-d // 128)
    bids = ops.ell_block_map(cols, vals, blk_d=128, n_d_blocks=nd, n_blocks_max=40)
    timed = {"sweep": lambda: S.ell_grad_update(cols, vals, W, coeff, s),
             "variant_4_byte_copies": lambda: S.ell_grad_update(cols, vals, W_off, coeff, s),
             "variant_tile512": c_sweep(tile512, cols, vals, W, coeff, s, res, 4),
             "fold": lambda: S.ell_grad_update_prefetch_fold(cols, vals, coeff, bids, W, s,
                                                             blk_d=128, n_d_blocks=nd),
             "floor_launch": lambda: floor.probe(res.data_ptr(), -(-d // 1024), m, 256, stream)}
    if par_sparse is not None:
        timed["parent"] = c_sweep(par_sparse, cols, vals, W, coeff, s, res, 512)
    us = {key: [] for key in timed}
    for rep in range(2):
        for key in (list(timed) if rep == 0 else list(timed)[::-1]):
            us[key].append(device_ms(torch, timed[key], 200) * 1e3)
    out["ell_grad_update_us"] = us
    print(f"ell_grad_update at ({m}, {B}, {k}), d {d}, us: "
          + ", ".join(f"{key} {v[0]:.3f} {v[1]:.3f}" for key, v in us.items()), flush=True)
    out["fails"] = fails
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
