"""Probes of two kernels' designs on one CUDA card: ``ell_margins_prefetch``
(with its coefficient entry) and ``rglru_scan``.

Three parts, timed with ``chip_smoke.device_ms`` in one process:

* check: both kernels and the coefficient entry against their plain
  versions at a CCAT-like minibatch (10 nodes, B = 1, k = 76, d = 47,236,
  frequent columns first, a 36-slot map) and at ragged shapes (pad rows,
  an all-pad node, undersized maps, a NaN value, k past one wave, a blk_d
  that is not a power of two; S and D off the scan's stage and block
  sizes), bit for bit where the port promises it, and timed beside
  ``--parent``'s kernels when given: another checkout whose
  ``ell_margins_prefetch`` C entry takes this one's arguments and whose
  ``rglru_scan`` takes no copy width (the first CUDA versions of both);
* floor: a launch at the prefetch margins' grid doing nothing, one round
  trip, and two dependent ones (entries, then W) with no map;
* variants: this checkout's sources with one design choice undone each (a
  division in place of the shift, four map slots a thread, four
  consecutive entries a thread; rings of other depths for the scan),
  built into ``build/probes/`` and timed beside the sources as they are.

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
_P, _I = ctypes.c_void_p, ctypes.c_int
MARGINS_ARGS = [_P] * 6 + [_I] * 7 + [_P]

FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k_empty(float* out) { if (threadIdx.x == 0) out[blockIdx.y] = 0.f; }
__global__ void k_one(const float* y, float* out) {
  if (threadIdx.x == 0) out[blockIdx.y] = __ldg(y + blockIdx.y);
}
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
// which: 0 a launch, 1 one round trip, 2 entries then W; one warp a node
extern "C" int probe(int which, const void* cols, const void* vals, const void* W,
                     const void* y, void* out, int m, int k, int d, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(1, m);
  if (which == 0) k_empty<<<grid, 32, 0, s>>>((float*)out);
  else if (which == 1) k_one<<<grid, 32, 0, s>>>((const float*)y, (float*)out);
  else k_two<<<grid, 32, 0, s>>>((const int*)cols, (const float*)vals, (const float*)W,
                                 (const float*)y, (float*)out, k, d);
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
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    from chip_smoke import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import sparse as S
    from repro_torch.kernels.rglru_scan import rglru_scan as RG

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sparse_src = KERNELS / "hinge_subgrad" / "csrc" / "sparse.cu"
    scan_src = KERNELS / "rglru_scan" / "csrc" / "rglru_scan.cu"
    margins_variants = {
        "division": {"    const int blk = blk_shift >= 0 ? c[j] >> blk_shift : c[j] / blk_d;\n":
                     "    const int blk = c[j] / blk_d;\n"},
        "four_map_slots": {"constexpr int kMapSlots = 2;": "constexpr int kMapSlots = 4;"},
        "consecutive_entries": {"    const int e = s + lane + j * tpr;\n":
                                "    const int e = s + lane * kRowEntries + j;\n"},
    }
    rings = [(32, 3), (16, 4), (16, 6), (32, 2), (32, 4), (32, 6), (48, 4), (64, 2)]
    sources = {"margins": sparse_src, "scan": scan_src}
    for name, edits in margins_variants.items():
        sources[f"margins_{name}"] = variant(sparse_src, f"margins_{name}", edits)
    for steps, stages in rings[1:]:
        sources[f"scan_{steps}x{stages}"] = variant(scan_src, f"scan_{steps}x{stages}", {
            "constexpr int kSteps = 32;": f"constexpr int kSteps = {steps};",
            "constexpr int kStages = 3;": f"constexpr int kStages = {stages};"})
    PROBES.mkdir(parents=True, exist_ok=True)
    (PROBES / "floor").mkdir(exist_ok=True)
    floor_src = PROBES / "floor" / "probe.cu"
    floor_src.write_text(FLOOR_SOURCE)
    sources["floor"] = floor_src
    if args.parent is not None:
        pk = args.parent.resolve() / "src" / "repro_torch" / "kernels"
        sources["parent_margins"] = pk / "hinge_subgrad" / "csrc" / "sparse.cu"
        sources["parent_scan"] = pk / "rglru_scan" / "csrc" / "rglru_scan.cu"
    _build.build(list(sources.values()))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out: dict = {"card": card}
    fails = []

    def check(ok: bool, what: str) -> None:
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            fails.append(what)

    def minibatch(m, B, k, d, cut=0, nan=False, skew=True, blk=128, n_blocks_max=None):
        if skew:  # frequent features crowd the first columns, as CCAT's do
            u = torch.rand(m, B, k, generator=gen, device=dev)
            cols = (u ** 3 * d).long().clamp(0, d - 1).to(torch.int32)
        else:
            cols = torch.randint(0, d, (m, B, k), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand(m, B, k, generator=gen, device=dev)
        pad = torch.rand(m, B, k, generator=gen, device=dev) < 0.2
        cols[pad], vals[pad] = 0, 0.0
        y = torch.where(torch.rand(m, B, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        if B > 2:
            cols[:, 2], vals[:, 2], y[:, 2] = 0, 0.0, 0.0
        if m > 1 and not skew:
            cols[1], vals[1], y[1] = 0, 0.0, 0.0
        vals = vals / vals.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        if nan:
            vals[0, 0, 0] = float("nan")
        W = 3 * torch.randn(m, d, generator=gen, device=dev)
        nd = -(-d // blk)
        live = max(len(torch.unique(c[v.nan_to_num(1.0) != 0] // blk)) for c, v in zip(cols, vals))
        bids = ops.ell_block_map(cols, vals.nan_to_num(1.0), blk_d=blk, n_d_blocks=nd,
                                 n_blocks_max=n_blocks_max or max(1, live - cut))
        return cols, vals, W, y, bids, blk, nd

    def same(a, b) -> bool:
        return torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))

    # check
    par_margins = par_scan = None
    if args.parent is not None:
        par_margins = _build.load(sources["parent_margins"], {"ell_margins_prefetch": MARGINS_ARGS})
        par_scan = _build.load(sources["parent_scan"], {"rglru_scan": [_P] * 3 + [_I] * 3 + [_P]})
    cases = {"ccat_like": dict(m=10, B=1, k=76, d=47236, n_blocks_max=36),
             "ragged": dict(m=3, B=5, k=13, d=1001, skew=False),
             "undersized": dict(m=3, B=5, k=13, d=1001, cut=1, skew=False),
             "nan": dict(m=3, B=5, k=13, d=1001, nan=True, skew=False),
             "k200": dict(m=2, B=7, k=200, d=5000),
             "k600": dict(m=2, B=3, k=600, d=70001),
             "B33": dict(m=4, B=33, k=100, d=20000, cut=2),
             "blk100": dict(m=3, B=5, k=16, d=1001, blk=100, cut=1, skew=False)}
    ccat = None
    for name, kw in cases.items():
        cols, vals, W, y, bids, blk, nd = minibatch(**kw)
        got = S.ell_margins_prefetch(cols, vals, W, y, bids, blk_d=blk, n_d_blocks=nd)
        want = S.ell_margins_prefetch_plain(cols, vals, W, y, bids, blk_d=blk, n_d_blocks=nd)
        mg, cf = S.ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=blk, n_d_blocks=nd)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max()) / max(1.0, float(want[fin].abs().max()))
        check(err <= 1e-5 and torch.equal(fin, torch.isfinite(got)),
              f"margins {name} {tuple(cols.shape)} map {tuple(bids.shape)}: rel err {err:.3e}")
        check(same(mg, got) and torch.equal(cf, torch.where(mg < 1.0, y, torch.zeros_like(y))),
              f"margins {name}: the coefficient entry's margins and torch.where of them, bit for bit")
        check(same(got, S.ell_margins_prefetch(cols, vals, W, y, bids, blk_d=blk, n_d_blocks=nd)),
              f"margins {name}: rerun")
        if name == "ccat_like":
            ccat = (cols, vals, W, y, bids, nd)
    cols, vals, W, y, bids, nd = ccat
    m, B, k = cols.shape
    d = W.shape[1]
    res = torch.empty_like(y)

    def c_margins(lib):
        return lambda: lib.ell_margins_prefetch(
            cols.data_ptr(), vals.data_ptr(), W.data_ptr(), y.data_ptr(), bids.data_ptr(),
            res.data_ptr(), m, B, k, d, bids.shape[1], 128, nd, stream)

    timed = {"margins": lambda: S.ell_margins_prefetch(cols, vals, W, y, bids, blk_d=128,
                                                        n_d_blocks=nd),
             "coeff": lambda: S.ell_margins_prefetch_coeff(cols, vals, W, y, bids, blk_d=128,
                                                           n_d_blocks=nd),
             "margins_then_where": lambda: torch.where(S.ell_margins_prefetch(
                 cols, vals, W, y, bids, blk_d=128, n_d_blocks=nd) < 1.0, y, torch.zeros_like(y))}
    if par_margins is not None:
        timed["parent"] = c_margins(par_margins)
    floor = _build.load(sources["floor"], {"probe": [_I] + [_P] * 5 + [_I] * 3 + [_P]})
    for which, tag in enumerate(("floor_launch", "floor_one_trip", "floor_two_trips")):
        timed[tag] = (lambda w=which: floor.probe(w, cols.data_ptr(), vals.data_ptr(), W.data_ptr(),
                                                  y.data_ptr(), res.data_ptr(), m, k, d, stream))
    want = S.ell_margins_prefetch_plain(cols, vals, W, y, bids, blk_d=128, n_d_blocks=nd)
    for name in margins_variants:
        lib = _build.load(sources[f"margins_{name}"], {"ell_margins_prefetch": MARGINS_ARGS})
        c_margins(lib)()
        torch.cuda.synchronize()
        check(float((res - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max())),
              f"margins variant {name} agrees")
        timed[f"variant_{name}"] = c_margins(lib)
    us = {key: [] for key in timed}
    for rep in range(2):  # in turns, the order reversed the second time
        for key in (list(timed) if rep == 0 else list(timed)[::-1]):
            # 200 calls: more of the four-launch margins-then-where would
            # overrun the launch queue and time the host
            us[key].append(device_ms(torch, timed[key], 200) * 1e3)
    out["margins_us"] = us
    print("margins at (10, 1, 76), map (10, 36), us: "
          + ", ".join(f"{key} {v[0]:.3f} {v[1]:.3f}" for key, v in us.items()), flush=True)

    scan_us = {}
    for (Bs, Ss, Ds) in ((2, 4096, 4096), (1, 4096, 4096), (1, 17, 130), (3, 100, 4100),
                         (2, 1, 4096), (2, 33, 1)):
        a = 0.8 + 0.199 * torch.rand(Bs, Ss, Ds, generator=gen, device=dev)
        b = torch.randn(Bs, Ss, Ds, generator=gen, device=dev)
        got, want = RG.rglru_scan(a, b), RG.rglru_scan_plain(a, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, RG.rglru_scan(a, b)),
              f"rglru_scan ({Bs}, {Ss}, {Ds}) bit for bit the plain version and its rerun, copy "
              f"width {RG.copy_width(Ds, a.data_ptr(), b.data_ptr())}")
        if Ss < 4096:
            continue
        h = torch.empty_like(a)
        timed = {"scan": lambda: RG.rglru_scan(a, b)}
        if par_scan is not None:
            timed["parent"] = lambda: par_scan.rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                                          Bs, Ss, Ds, stream)
        for steps, stages in rings[1:]:
            lib = _build.load(sources[f"scan_{steps}x{stages}"],
                              {"rglru_scan": [_P] * 3 + [_I] * 4 + [_P]})
            timed[f"ring_{steps}x{stages}"] = (lambda lib=lib: lib.rglru_scan(
                a.data_ptr(), b.data_ptr(), h.data_ptr(), Bs, Ss, Ds, 4, stream))
            timed[f"ring_{steps}x{stages}"]()
            torch.cuda.synchronize()
            check(torch.equal(h, want), f"rglru_scan ring {steps} x {stages} bit for bit")
        us = {key: [] for key in timed}
        for rep in range(2):
            for key in (list(timed) if rep == 0 else list(timed)[::-1]):
                us[key].append(device_ms(torch, timed[key], 20) * 1e3)
        scan_us[f"{Bs}x{Ss}x{Ds}"] = us
        print(f"rglru_scan ({Bs}, {Ss}, {Ds}), us (this source: {rings[0][0]} steps x "
              f"{rings[0][1]} stages): " + ", ".join(f"{key} {v[0]:.1f} {v[1]:.1f}"
                                                     for key, v in us.items()), flush=True)
        del a, b, got, want, h
    out["rglru_scan_us"] = scan_us
    out["fails"] = fails
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
