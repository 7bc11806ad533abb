"""Probes of four kernels' designs on one CUDA card: ``grad_update`` (the
fleet form), ``ell_grad_update`` (the sweep grad), ``ell_margins`` (the sweep
margins, with its coefficient entry ``ell_margins_coeff``) and
``ell_scores_prefetch`` (the serving scores).

Three parts for each kernel, timed with ``chip_smoke.device_ms`` in one
process, in turns (the order reversed the second time):

* check: the kernel against its plain version at its main path's shape and
  at ragged ones, each rerun bit for bit where the port promises it, and,
  with ``--parent`` (another checkout whose C entries of these kernels take
  this checkout's arguments, such as the parent commit unpacked by ``git
  archive`` under ``build/``), the parent's kernel against the plain
  version too;
* floor: a launch doing nothing at the kernel's grid (for the margins also
  a warp a node doing the two dependent round trips, entries then W, and
  nothing else);
* variants: the kernel with one design choice undone, each a text edit of
  its source or of the headers beside it (``variant``), built under
  ``build/probes/`` and timed beside the kernel as it is, the parent's and
  the one PyTorch call that computes the same function.
  ``grad_update``: blocks of 128 threads, and B = 1 through the rows
  kernel. ``ell_grad_update``: 512-column tiles, and 4-byte copies.
  ``ell_margins``: none (the parent's lane-strided walk is the design
  undone; its coefficients then come from the three launches of
  ``torch.where``). ``ell_scores_prefetch``: a division for ``col //
  blk_d``, the map loaded after the first barrier, two map slots a thread
  (the top bucket's 259 then take a second round trip), launch bounds
  without the floor of one block an SM (ptxas then keeps the C = 1 kernel
  in 32 registers and spills), and the bucket
  batch (8 rows of one warp) in one block of 8 warps, 4 blocks of 2 and 8
  of 1 in place of 2 of 4, each with the map slots a thread that keep the
  top bucket's map one round trip; at C = 1 and C = 4.

``--kernels`` runs only the named ones (comma-separated).

Usage:
    python3 tools/kernel_probes.py [--parent CHECKOUT] [--kernels NAMES]
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
CSRC = KERNELS / "hinge_subgrad" / "csrc"
PROBES = HERE / "build" / "probes"
NAMES = ("grad_update", "ell_grad_update", "ell_margins", "ell_scores_prefetch")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
GRAD_ARGS = [_P] * 4 + [_I] * 3 + [_F] * 2 + [_P]
SWEEP_ARGS = [_P] * 5 + [_I] * 5 + [_F] * 2 + [_P]
MARGINS_ARGS = [_P] * 5 + [_I] * 4 + [_P]
SCORES_ARGS = [_P] * 6 + [_I] * 9 + [_P]

FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_empty(float* out) { if (threadIdx.x == 0 && blockIdx.x == 0) out[blockIdx.y] = 0.f; }
__global__ void k_two(const int* cols, const float* vals, const float* W, const float* y,
                      float* out, int k, int d) {
  const int i = blockIdx.y, lane = threadIdx.x;
  int c[4];
  float v[4], acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = lane + 32 * j;
    c[j] = e < k ? __ldg(cols + i * k + e) : 0;
    v[j] = e < k ? __ldg(vals + i * k + e) : 0.f;
  }
  const float yb = __ldg(y + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool use = v[j] != 0.f && (unsigned)c[j] < (unsigned)d;
    acc = fmaf(v[j], use ? __ldg(W + (size_t)i * d + c[j]) : 0.f, acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = yb * acc;
}
// an empty kernel at a grid of (gx, gy) blocks of `threads`
extern "C" int probe(void* out, int gx, int gy, int threads, void* stream) {
  k_empty<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>((float*)out);
  return (int)cudaGetLastError();
}
// a warp a node (B = 1, k <= 128): its entries, then W, then the sum
extern "C" int probe_two(const void* cols, const void* vals, const void* W, const void* y,
                         void* out, int m, int k, int d, void* stream) {
  k_two<<<dim3(1, m), 32, 0, (cudaStream_t)stream>>>((const int*)cols, (const float*)vals,
                                                      (const float*)W, (const float*)y,
                                                      (float*)out, k, d);
  return (int)cudaGetLastError();
}
"""


def variant(src: Path, name: str, edits: dict) -> Path:
    """``src`` and the headers beside it, with each of ``edits`` (old text ->
    new text) applied to the one file that holds the old text once, under
    build/probes/<name>/."""
    files = {f.name: f.read_text() for f in [src, *sorted(src.parent.glob("*.cuh"))]}
    for old, new in edits.items():
        holders = [n for n, text in files.items() if old in text]
        if len(holders) != 1 or files[holders[0]].count(old) != 1:
            raise RuntimeError(f"{src.name}: {old!r} is not in the sources once; update the probe")
        files[holders[0]] = files[holders[0]].replace(old, new)
    out = PROBES / name
    out.mkdir(parents=True, exist_ok=True)
    for n, text in files.items():
        (out / n).write_text(text)
    return out / src.name


SCORES_VARIANTS = {
    "division": {"    const int blk = blk_shift >= 0 ? c[j] >> blk_shift : c[j] / blk_d;\n":
                 "    const int blk = c[j] / blk_d;\n"},
    "map_after_barrier": {
        "    bid[q] = slot < n_blocks_max ? __ldg(block_ids + slot) : -1;\n": "    bid[q] = -1;\n",
        "  set_map_bits(bitmap, bid, block_ids, n_blocks_max, n_d_blocks, tid, nt);\n":
        "  set_map_bits(bitmap, bid, block_ids, n_blocks_max, n_d_blocks, tid - kScoreMapSlots * nt,"
        " nt);\n"},
    "map_in_two_trips": {"constexpr int kScoreMapSlots = 3;": "constexpr int kScoreMapSlots = 2;"},
    "bounds_without_min_blocks": {"__global__ void __launch_bounds__(kScoreBlockMax, 1)\n":
                                  "__global__ void __launch_bounds__(kScoreBlockMax)\n"},
}
# blocks of 8, 2 and 1 warps at the bucket batch (8 rows of one warp), the
# map slots a thread chosen so that the top bucket's 259 are one round trip
for _name, _threads, _slots in (("one_block", 256, 2), ("four_blocks", 64, 5),
                                ("eight_blocks", 32, 9)):
    SCORES_VARIANTS[_name] = {
        "constexpr int kScoreThreads = 128;": f"constexpr int kScoreThreads = {_threads};",
        "constexpr int kScoreMapSlots = 3;": f"constexpr int kScoreMapSlots = {_slots};"}


def main() -> int:
    """Run the three parts of each named kernel; one JSON line at the end."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="checkout whose kernels (same C entries) to check and time beside")
    ap.add_argument("--kernels", default=",".join(NAMES),
                    help=f"comma-separated, of {', '.join(NAMES)}")
    args = ap.parse_args()
    names = [n.strip() for n in args.kernels.split(",")]
    if set(names) - set(NAMES):
        print(f"kernel_probes: unknown kernels {sorted(set(names) - set(NAMES))}", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    from chip_smoke import device_ms, ptxas_resources, rel_err
    from repro_torch.kernels import _build
    from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import predict as P
    from repro_torch.kernels.hinge_subgrad import sparse as S

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    src = {"sparse": CSRC / "sparse.cu", "dense": CSRC / "hinge_subgrad.cu",
           "predict": CSRC / "predict.cu"}
    sources = {"tile512": variant(src["sparse"], "tile512", {
        "constexpr int kTileLanes = kThreads * 4;": "constexpr int kTileLanes = kThreads * 2;"}),
        "threads128": variant(src["dense"], "threads128", {
            "constexpr int kGradThreads = kThreads;": "constexpr int kGradThreads = 128;"}),
        "rows_b1": variant(src["dense"], "rows_b1", {"  if (B == 1)\n": "  if (false)\n"})}
    for name, edits in SCORES_VARIANTS.items():
        sources[f"scores_{name}"] = variant(src["predict"], f"scores_{name}", edits)
    (PROBES / "floor").mkdir(parents=True, exist_ok=True)
    sources["floor"] = PROBES / "floor" / "probe.cu"
    sources["floor"].write_text(FLOOR_SOURCE)
    parent = {}
    if args.parent is not None:
        pk = args.parent.resolve() / "src" / "repro_torch" / "kernels" / "hinge_subgrad" / "csrc"
        parent = {key: pk / path.name for key, path in src.items()}
    libs = _build.build(list(sources.values()) + list(src.values()) + list(parent.values()))
    for name, path in libs.items():  # registers and spills of each build's kernels
        res = ptxas_resources(path.with_suffix(".log").read_text())
        print(f"ptxas {name.parent.name}/{name.name}: " + "; ".join(
            f"{k} {v.get('registers')} registers, {v.get('spill_stores')} B spilled"
            for k, v in res.items() if "dense" not in k), flush=True)

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

    def same(a, b) -> bool:
        """Bit for bit, NaN where NaN."""
        return torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))

    def in_turns(timed: dict, n: int = 200) -> dict:
        """Each entry's device us a call, twice, the order reversed the second time."""
        us = {key: [] for key in timed}
        for rep in range(2):
            for key in (list(timed) if rep == 0 else list(timed)[::-1]):
                us[key].append(device_ms(torch, timed[key], n) * 1e3)
        return us

    def show(title: str, us: dict) -> None:
        print(f"{title}, us: " + ", ".join(f"{key} {v[0]:.3f} {v[1]:.3f}" for key, v in us.items()),
              flush=True)

    floor = _build.load(sources["floor"], {"probe": [_P, _I, _I, _I, _P],
                                           "probe_two": [_P] * 5 + [_I] * 3 + [_P]})
    par_dense = par_sparse = par_predict = None
    if parent:
        par_dense = _build.load(parent["dense"], {"grad_update": GRAD_ARGS})
        par_sparse = _build.load(parent["sparse"], {"ell_grad_update": SWEEP_ARGS,
                                                    "ell_margins": MARGINS_ARGS})
        par_predict = _build.load(parent["predict"], {"ell_scores_prefetch": SCORES_ARGS})

    def ccat_like(m=10, k=76, d=47236, pad=5):
        """A CCAT-like minibatch at B = 1: k distinct columns a row, frequent
        columns first, the last ``pad`` entries of each row pad entries."""
        u = torch.rand(m, 4 * k, generator=gen, device=dev)
        cols = torch.stack([torch.unique((u[i] ** 3 * d).long())[:k] for i in range(m)])
        cols = cols[:, None].to(torch.int32).contiguous()
        vals = torch.rand(m, 1, cols.shape[-1], generator=gen, device=dev)
        cols[..., -pad:], vals[..., -pad:] = 0, 0.0
        vals /= vals.norm(dim=-1, keepdim=True)
        W = 3 * torch.randn(m, d, generator=gen, device=dev)
        y = torch.where(torch.rand(m, 1, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        return cols, vals, W, y

    def ragged(m, B, k, d, shared=False, pad_node=False, nan=False):
        cols = torch.randint(0, d, (m, B, k), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand(m, B, k, generator=gen, device=dev)
        pad = torch.rand(m, B, k, generator=gen, device=dev) < 0.25
        cols[pad], vals[pad] = 0, 0.0
        if shared:
            cols[0, :, 0], vals[0, :, 0] = 17, 0.5
        if pad_node:
            cols[1], vals[1] = 0, 0.0
        vals = vals / vals.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        if nan:
            vals[0, 0, 0] = float("nan")
        W = 3 * torch.randn(m, d, generator=gen, device=dev)
        y = torch.where(torch.rand(m, B, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        if B > 2:
            y[:, 2] = 0.0
        return cols, vals, W, y

    # ---------------------------------------------------------- grad_update
    if "grad_update" in names:
        threads128 = _build.load(sources["threads128"], {"grad_update": GRAD_ARGS})
        rows_b1 = _build.load(sources["rows_b1"], {"grad_update": GRAD_ARGS})

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
            """A grad_update C entry of a variant's or of the parent's."""
            m, B, d = X.shape
            return lambda: lib.grad_update(X.data_ptr(), W.data_ptr(), c.data_ptr(),
                                           res.data_ptr(), m, B, d, s[0], s[1], stream)

        main = None
        for m, B, d in ((10, 1, 8315), (1, 1, 8315), (3, 37, 1001), (2, 5, 8316), (4, 1, 3),
                        (3, 2, 1), (32, 1, 70001)):
            X, W, c, s = fleet(m, B, d)
            got, want = K.grad_update(X, W, c, s), K.grad_update_plain(X, W, c, s)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            check(err[1] <= 1e-5, f"grad_update ({m}, {B}, {d}): rel err {err[1]:.3e}, "
                  f"bit for bit the plain version: {torch.equal(got, want)}")
            check(torch.equal(got, stacked(X, W, c, s))
                  and torch.equal(got, K.grad_update(X, W, c, s))
                  and torch.equal(got, K.grad_update(off_grid(X), W, c, s)),
                  f"grad_update ({m}, {B}, {d}): the one-node launches stacked, a rerun and an X "
                  "off the 16-byte grid, bit for bit")
            res = torch.empty_like(W)
            runs = [("blocks of 128", threads128), ("the rows kernel", rows_b1)]
            if par_dense is not None:
                runs.append(("the parent", par_dense))
            for tag, lib in runs:
                res.fill_(float("nan"))
                code = c_grad(lib, X, W, c, s, res)()
                torch.cuda.synchronize()
                ok = torch.equal(res, got) if tag != "the parent" else rel_err(res, want)[1] <= 1e-5
                check(code == 0 and ok, f"grad_update ({m}, {B}, {d}), {tag}: agrees")
            if (m, B, d) == (10, 1, 8315):
                main = (X, W, c, s)
        X, W, c, s = main
        one_minus = float(np.float32(1) - np.float32(s[0]))
        X1, w1, c1 = (a[0].clone() for a in (X, W, c))
        res = torch.empty_like(W)
        timed = {"fleet": lambda: K.grad_update(X, W, c, s),
                 "one_node": lambda: K.grad_update(X1, w1, c1, s),
                 "fleet_as_one_node_loop": lambda: stacked(X, W, c, s),
                 "variant_threads128": c_grad(threads128, X, W, c, s, res),
                 "variant_rows_kernel": c_grad(rows_b1, X, W, c, s, res),
                 "baddbmm": lambda: torch.baddbmm(W[:, None, :], c[:, None, :], X,
                                                  beta=one_minus, alpha=s[1]),
                 "addmv_one_node": lambda: torch.addmv(w1, X1.t(), c1, beta=one_minus,
                                                       alpha=s[1]),
                 "floor_launch": lambda: floor.probe(res.data_ptr(), 33, 10, 256, stream)}
        if par_dense is not None:
            timed["parent"] = c_grad(par_dense, X, W, c, s, torch.empty_like(W))
        # 50 calls of the eleven-launch loop stay within the launch queue
        us = in_turns({k: v for k, v in timed.items() if "loop" not in k})
        us.update(in_turns({k: v for k, v in timed.items() if "loop" in k}, 50))
        out["grad_update_us"] = us
        show("grad_update at (10, 1, 8315), grid (33, 10) x 256", us)

    # ------------------------------------------------------ ell_grad_update
    if "ell_grad_update" in names:
        tile512 = _build.load(sources["tile512"], {"ell_grad_update": SWEEP_ARGS})

        def with_coeff(cols, vals, W, y):
            coeff = torch.where(S.ell_margins_plain(cols, vals, W, y) < 1.0, y,
                                torch.zeros_like(y))
            return cols, vals, W, coeff, ops.step_scalars(1e-4, 1000, cols.shape[1])

        def c_sweep(lib, cols, vals, W, coeff, s, res):
            m, B, k = cols.shape
            vec = _build.copy_width(W.shape[1], W.data_ptr(), res.data_ptr())
            return lambda: lib.ell_grad_update(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                               coeff.data_ptr(), res.data_ptr(), m, B, k,
                                               W.shape[1], vec, s[0], s[1], stream)

        ccat = ccat_like()
        ccat[2][0, :7] = -0.0
        cases = {"ccat_like": with_coeff(*ccat),
                 "shared": with_coeff(*ragged(3, 5, 13, 1001, shared=True)),
                 "pad_node": with_coeff(*ragged(3, 5, 13, 1004, pad_node=True)),
                 "entries_12000": with_coeff(*ragged(2, 40, 300, 3000, shared=True))}
        for name, (cols, vals, W, coeff, s) in cases.items():
            got = S.ell_grad_update(cols, vals, W, coeff, s)
            want = S.ell_grad_update_plain(cols, vals, W, coeff, s)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            check(torch.equal(got, want) if name == "ccat_like" else err[1] <= 1e-5,
                  f"ell_grad_update {name} {tuple(cols.shape)}, d {W.shape[1]}: rel err "
                  f"{err[1]:.3e}, bit for bit: {torch.equal(got, want)}")
            check(all(torch.equal(S.ell_grad_update(cols, vals, w_, coeff, s, blk_d=b_), got)
                      for w_, b_ in ((W, 128), (W, 1000), (off_grid(W), 512))),
                  f"ell_grad_update {name}: every blk_d, a rerun and a W off the 16-byte grid, "
                  "bit for bit")
            res = torch.empty_like(W)
            c_sweep(tile512, cols, vals, W, coeff, s, res)()
            torch.cuda.synchronize()
            check(torch.equal(res, got), f"ell_grad_update {name}: 512-column tiles, bit for bit")
            if par_sparse is not None:
                c_sweep(par_sparse, cols, vals, W, coeff, s, res)()
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
                 "variant_tile512": c_sweep(tile512, cols, vals, W, coeff, s, res),
                 "fold": lambda: S.ell_grad_update_prefetch_fold(cols, vals, coeff, bids, W, s,
                                                                 blk_d=128, n_d_blocks=nd),
                 "floor_launch": lambda: floor.probe(res.data_ptr(), -(-d // 1024), m, 256,
                                                     stream)}
        if par_sparse is not None:
            timed["parent"] = c_sweep(par_sparse, cols, vals, W, coeff, s, res)
        us = in_turns(timed)
        out["ell_grad_update_us"] = us
        show(f"ell_grad_update at ({m}, {B}, {k}), d {d}", us)

    # ---------------------------------------------------------- ell_margins
    if "ell_margins" in names:
        def c_margins(lib, cols, vals, W, y, res):
            m, B, k = cols.shape
            return lambda: lib.ell_margins(cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                           y.data_ptr(), res.data_ptr(), m, B, k, W.shape[1],
                                           stream)

        cases = {"ccat_like": ccat_like(), "ragged": ragged(3, 5, 13, 1001, pad_node=True),
                 "nan": ragged(3, 5, 13, 1001, nan=True), "k600": ragged(2, 3, 600, 47236),
                 "B33": ragged(4, 33, 100, 20000, shared=True)}
        for name, (cols, vals, W, y) in cases.items():
            got = S.ell_margins(cols, vals, W, y)
            want = S.ell_margins_plain(cols, vals, W, y)
            mg, cf = S.ell_margins_coeff(cols, vals, W, y)
            nd = -(-W.shape[1] // 128)
            bids = ops.ell_block_map(cols, vals.nan_to_num(1.0), blk_d=128, n_d_blocks=nd,
                                     n_blocks_max=nd)
            mg_pf, cf_pf = S.ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=128,
                                                        n_d_blocks=nd)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got - want)[fin].abs().max()) / max(1.0, float(want[fin].abs().max()))
            check(err <= 1e-5 and torch.equal(fin, torch.isfinite(got)),
                  f"ell_margins {name} {tuple(cols.shape)}, d {W.shape[1]}: rel err {err:.3e}")
            check(same(mg, got) and torch.equal(cf, torch.where(mg < 1.0, y, torch.zeros_like(y))),
                  f"ell_margins {name}: the coefficient entry's margins and torch.where of them, "
                  "bit for bit")
            check(same(mg_pf, got) and torch.equal(cf_pf, cf),
                  f"ell_margins {name}: the prefetch coefficient entry's at a sound map, bit for bit")
            check(same(S.ell_margins(cols, vals, W, y), got), f"ell_margins {name}: rerun")
            if par_sparse is not None:
                res = torch.empty_like(y)
                c_margins(par_sparse, cols, vals, W, y, res)()
                torch.cuda.synchronize()
                e = float((res - want)[fin].abs().max()) / max(1.0, float(want[fin].abs().max()))
                check(e <= 1e-5, f"parent ell_margins {name}: rel err {e:.3e}")
        cols, vals, W, y = cases["ccat_like"]
        m, B, k = cols.shape
        d = W.shape[1]
        nd = -(-d // 128)
        bids = ops.ell_block_map(cols, vals, blk_d=128, n_d_blocks=nd, n_blocks_max=36)
        res = torch.empty_like(y)
        cols_flat = (cols.long() + d * torch.arange(m, device=dev)[:, None, None]).reshape(m * B, k)
        vals_flat, W_flat = vals.reshape(m * B, k), W.reshape(m * d, 1)
        timed = {"margins": lambda: S.ell_margins(cols, vals, W, y),
                 "coeff": lambda: S.ell_margins_coeff(cols, vals, W, y),
                 "margins_then_where": lambda: torch.where(S.ell_margins(cols, vals, W, y) < 1.0, y,
                                                           torch.zeros_like(y)),
                 "prefetch_coeff": lambda: S.ell_margins_prefetch_coeff(
                     cols, vals, W, y, bids, blk_d=128, n_d_blocks=nd),
                 "embedding_bag": lambda: torch.nn.functional.embedding_bag(
                     cols_flat, W_flat, per_sample_weights=vals_flat, mode="sum"),
                 "floor_launch": lambda: floor.probe(res.data_ptr(), 1, m, 32, stream),
                 "floor_two_trips": lambda: floor.probe_two(cols.data_ptr(), vals.data_ptr(),
                                                            W.data_ptr(), y.data_ptr(),
                                                            res.data_ptr(), m, k, d, stream)}
        if par_sparse is not None:
            par = c_margins(par_sparse, cols, vals, W, y, res)
            timed["parent"] = par
            timed["parent_then_where"] = lambda: (par(), torch.where(res < 1.0, y,
                                                                     torch.zeros_like(y)))
        us = in_turns(timed)
        out["ell_margins_us"] = us
        show(f"ell_margins at ({m}, {B}, {k}), d {d}, grid (1, {m}) x 32", us)

    # -------------------------------------------------- ell_scores_prefetch
    if "ell_scores_prefetch" in names:
        variants = {name: _build.load(sources[f"scores_{name}"],
                                      {"ell_scores_prefetch": SCORES_ARGS})
                    for name in SCORES_VARIANTS}

        def c_scores(lib, cols, vals, W, bids, blk, nd, S_, L_):
            B, k = cols.shape
            C, d = W.shape
            return lambda: lib.ell_scores_prefetch(
                cols.data_ptr(), vals.data_ptr(), W.data_ptr(), bids.data_ptr(), S_.data_ptr(),
                L_.data_ptr(), B, k, d, C, C, P.nan_label(C), bids.shape[0], blk, nd, stream)

        def queries(B, k, d, C, blk=128, cut=0, width=None, nan=False, pad_rows=0):
            """B CCAT-like queries (frequent columns first, some pad entries),
            W (C, d) with classes 0 and C - 1 tied, the batch's map at
            ``width`` slots (the live count by default, ``cut`` fewer)."""
            u = torch.rand(B, k, generator=gen, device=dev)
            cols = (u ** 3 * d).long().clamp(0, d - 1).to(torch.int32)
            vals = torch.rand(B, k, generator=gen, device=dev)
            pad = torch.rand(B, k, generator=gen, device=dev) < 0.2
            cols[pad], vals[pad] = 0, 0.0
            if pad_rows:
                cols[-pad_rows:], vals[-pad_rows:] = 0, 0.0
            vals = vals / vals.norm(dim=-1, keepdim=True).clamp(min=1e-8)
            if nan:
                vals[0, 0] = float("nan")
            W = torch.randn(C, d, generator=gen, device=dev)
            if C > 1:
                W[C - 1] = W[0]
            nd = -(-d // blk)
            live = len(torch.unique(cols[vals.nan_to_num(1.0) != 0] // blk))
            bids = ops.ell_block_map(cols[None], vals.nan_to_num(1.0)[None], blk_d=blk,
                                     n_d_blocks=nd, n_blocks_max=width or max(1, live - cut))[0]
            return cols, vals, W, bids, blk, nd

        cases = {"serving": queries(8, 76, 47236, 1, width=259),
                 "C4_pad_rows": queries(8, 76, 47236, 4, width=259, pad_rows=2),
                 "C20": queries(8, 76, 47236, 20, width=259),
                 "k600": queries(3, 600, 47236, 4, width=370),
                 "undersized": queries(8, 76, 47236, 4, cut=1),
                 "nan": queries(8, 19, 47236, 4, nan=True),
                 "blk100": queries(5, 30, 10001, 3, blk=100, cut=1),
                 "B37_C6": queries(37, 200, 20000, 6)}
        for name, (cols, vals, W, bids, blk, nd) in cases.items():
            kw = dict(blk_d=blk, n_d_blocks=nd, n_classes=W.shape[0])
            got, lbl = P.ell_scores_prefetch(cols, vals, W, bids, **kw)
            want, lbl_p = P.ell_scores_prefetch_plain(cols, vals, W, bids, **kw)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            err = float((got - want)[fin].abs().max()) / max(1.0, float(want[fin].abs().max()))
            check(err <= 1e-5 and torch.equal(fin, torch.isfinite(got)) and torch.equal(lbl, lbl_p),
                  f"ell_scores_prefetch {name} {tuple(cols.shape)}, W {tuple(W.shape)}, map "
                  f"{bids.shape[0]}: rel err {err:.3e}, labels equal: {torch.equal(lbl, lbl_p)}")
            again, lbl2 = P.ell_scores_prefetch(cols, vals, W, bids, **kw)
            check(same(again, got) and torch.equal(lbl2, lbl), f"ell_scores_prefetch {name}: rerun")
            S_, L_ = torch.empty_like(got), torch.empty_like(lbl)
            libs = dict(variants, **({"parent": par_predict} if par_predict is not None else {}))
            for tag, lib in libs.items():
                S_.fill_(float("nan"))
                code = c_scores(lib, cols, vals, W, bids, blk, nd, S_, L_)()
                torch.cuda.synchronize()
                e = float((S_ - want)[fin].abs().max()) / max(1.0, float(want[fin].abs().max()))
                check(code == 0 and e <= 1e-5, f"ell_scores_prefetch {name}, {tag}: rel err {e:.3e}")
        for C in (1, 4):
            cols, vals, W, bids, blk, nd = cases["serving" if C == 1 else "C4_pad_rows"]
            S_ = torch.empty(cols.shape[0], C, device=dev)
            L_ = torch.empty(cols.shape[0], dtype=torch.int32, device=dev)
            W_t = W.t().contiguous()
            timed = {"scores": lambda: P.ell_scores_prefetch(cols, vals, W, bids, blk_d=blk,
                                                             n_d_blocks=nd, n_classes=C)}
            timed.update({f"variant_{tag}": c_scores(lib, cols, vals, W, bids, blk, nd, S_, L_)
                          for tag, lib in variants.items()})
            if par_predict is not None:
                timed["parent"] = c_scores(par_predict, cols, vals, W, bids, blk, nd, S_, L_)
            timed["embedding_bag"] = lambda: torch.nn.functional.embedding_bag(
                cols, W_t, per_sample_weights=vals, mode="sum")
            timed["floor_launch"] = lambda: floor.probe(S_.data_ptr(), 1, 1, 256, stream)
            us = in_turns(timed)
            out[f"ell_scores_prefetch_C{C}_us"] = us
            show(f"ell_scores_prefetch at ({cols.shape[0]}, {cols.shape[1]}), W ({C}, "
                 f"{W.shape[1]}), map ({bids.shape[0]},)", us)
    out["fails"] = fails
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
