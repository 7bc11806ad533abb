"""Device time, kernel launches and iteration rate of the port's SVM
training and serving paths on one CUDA card, for this checkout or another
one.

Runs ``repro_torch`` from ``<root>/src`` (this checkout's by default) on the
paper's reuters run (10 nodes, B=1, R=4, random topology) fused and
unfused, and on its CCAT run as ELL planes at full width (rows cut to a
tenth) with the prefetch and the sweep schedule. For each path it prints
the iterations per second of an unprofiled run of ``--iters`` iterations
(host clock, ending in a device sync), and from torch.profiler over a run
of ``--profile-iters``: device time (in all, and in kernels alone),
kernel launches and copies per iteration
(``chip_smoke.profile_iterations``). The configurations are
``chip_smoke.py``'s phases 4, 5, 7 and 8, so two checkouts' paths compare
by one method, in turns within one call on one card. The path "ccat
serving" is phase 10's whole pass: every CCAT test query scored by an
``SvmServer`` (seeded random weights) through the buckets calibrated on
training rows; queries per second on the host clock, and device time,
kernel time and kernel launches per batch from torch.profiler over a
second pass.

``--paths`` runs only the named paths (comma-separated, e.g. "ccat sweep"),
and ``--repeat`` times each path's unprofiled run that many times, to show
the spread of its iterations per second.

Usage:
    python3 tools/profile_paths.py [--root CHECKOUT] [--iters 400] [--paths NAMES] [--repeat 1]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    """Profile every path; one JSON line at the end."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose src/repro_torch is profiled")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--profile-iters", type=int, default=200)
    ap.add_argument("--paths", help="comma-separated path names; all five by default")
    ap.add_argument("--repeat", type=int, default=1, help="unprofiled runs of each path")
    args = ap.parse_args()
    root = args.root.resolve()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"profile_paths: no src/repro_torch under {root}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("profile_paths: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import CCAT_SCALE, N_NODES, profile_iterations
    from repro_torch.configs.gadget_svm import PAPER_RUNS
    from repro_torch.core.gadget import gadget_train
    from repro_torch.data.svm_datasets import make_dataset, partition

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; repro_torch from {root / 'src'}", flush=True)
    dev = torch.device("cuda")
    ds = make_dataset("reuters", scale=1.0, seed=0)
    Xp, yp, n_r = partition(ds.X_train, ds.y_train, N_NODES, seed=0)
    dense = (torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev), n_r)
    ds_c = make_dataset("ccat", scale=CCAT_SCALE, seed=0, sparse=True)
    sparse = partition(ds_c.X_train, ds_c.y_train, N_NODES, seed=0)
    cfg_r, cfg_c = PAPER_RUNS["reuters"].gadget, PAPER_RUNS["ccat"].gadget
    paths = {"reuters fused": (dense, cfg_r),
             "reuters unfused": (dense, cfg_r._replace(fused=False)),
             "ccat prefetch": (sparse, cfg_c._replace(sparse_schedule="prefetch")),
             "ccat sweep": (sparse, cfg_c._replace(sparse_schedule="sweep")),
             "ccat serving": None}
    if args.paths:
        names = [n.strip() for n in args.paths.split(",")]
        unknown = set(names) - set(paths)
        if unknown:
            print(f"profile_paths: unknown paths {sorted(unknown)}; known: {list(paths)}",
                  file=sys.stderr)
            return 2
        paths = {n: paths[n] for n in names}
    out = {"card": card}
    for name, path in paths.items():
        if path is None:
            out[name] = serving(torch, ds_c, sparse[0], args.repeat)
            continue
        (X, y, n_counts), cfg = path

        def run(iters, X=X, y=y, n_counts=n_counts, cfg=cfg):
            return gadget_train(X, y, cfg._replace(max_iters=iters), n_counts=n_counts, device=dev)
        run(20)  # warm-up: the libraries and cuBLAS
        rates = []
        for _ in range(args.repeat):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(args.iters)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            rates.append(res.iters / wall_s)
        prof = profile_iterations(torch, lambda: run(args.profile_iters))
        n = args.profile_iters
        out[name] = {"iters_per_s": res.iters / wall_s,
                     "device_us_per_iter": prof["device_us"] / n,
                     "kernel_us_per_iter": prof["kernel_us"] / n,
                     "kernel_launches_per_iter": prof["kernel_launches"] / n,
                     "copies_per_iter": prof["copies"] / n,
                     "busy_share": prof["device_us"] / n / (wall_s / res.iters * 1e6)}
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in out[name].items()), flush=True)
        if args.repeat > 1:
            out[name]["iters_per_s_runs"] = rates
            print("    iterations/s of each run: " + ", ".join(f"{r:.1f}" for r in rates), flush=True)
        for key, count, us in prof["top_device"]:
            print(f"    device {us / n:9.2f} us/it  x{count:<6d} {key}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def serving(torch, ds_c, parts, repeat: int) -> dict:
    """Every CCAT test query through an ``SvmServer`` and calibrated buckets,
    as chip_smoke.py's phase 10 serves them."""
    import numpy as np
    from chip_smoke import (SERVE_MIN_K, SERVE_ROWS, SERVE_SAMPLE, ccat_queries,
                            profile_iterations, serve_queries)
    from repro_torch import serve
    from repro_torch.sparse import formats
    d, k_max = ds_c.X_test.shape[1], ds_c.X_test.k_max
    rows = SERVE_ROWS
    buckets = serve.calibrate_buckets(
        serve.bucket_ladder(k_max, rows=rows, min_k=SERVE_MIN_K, d=d),
        parts.cols.reshape(-1, k_max)[:SERVE_SAMPLE], parts.vals.reshape(-1, k_max)[:SERVE_SAMPLE],
        d)
    w = np.random.default_rng(0).normal(size=d).astype(np.float32)
    srv = serve.SvmServer.from_snapshot(serve.Snapshot(1, w, 0.0))
    queries = ccat_queries(ds_c.X_test, ragged=False)
    serve_queries(srv, buckets, queries[:rows], formats.pad_query_planes)  # warm-up
    rates = []
    for _ in range(repeat):
        res = serve_queries(srv, buckets, queries, formats.pad_query_planes)
        rates.append(len(queries) / res["seconds"])
    prof = profile_iterations(torch, lambda: serve_queries(srv, buckets, queries,
                                                           formats.pad_query_planes))
    n = res["batches"]
    out = {"queries_per_s": rates[-1], "batches": n,
           "device_us_per_batch": prof["device_us"] / n,
           "kernel_us_per_batch": prof["kernel_us"] / n,
           "kernel_launches_per_batch": prof["kernel_launches"] / n,
           "busy_share": prof["device_us"] / n / (1e3 * res["batch_ms"])}
    print("ccat serving: " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    if repeat > 1:
        out["queries_per_s_runs"] = rates
        print("    queries/s of each run: " + ", ".join(f"{r:.1f}" for r in rates), flush=True)
    for key, count, us in prof["top_device"]:
        print(f"    device {us / n:9.2f} us/batch  x{count:<6d} {key}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
