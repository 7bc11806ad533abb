#!/usr/bin/env python3
"""Where a gloo mesh step's time goes on one card: ``chip_smoke.py`` phase
21's four ranks with their tensors on the card (staged through host buffers
for gloo) and on the host, same data, in turns.

    python3 tools/mesh_probe.py [--repeat 2] [--world 4]

Each rank trains its quarter of reuters (ELL planes made dense) for
``chip_smoke.MESH_STEPS`` mesh steps with kernels on the card, or with the
plain PyTorch step on the host, and reports its µs a step and the share of
it inside the mesh's exchanges (``Mesh.stats()``), one line a rank and a
JSON line of everything last. It needs one CUDA card (the host run spawns
the same ranks).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    """Run the ranks on each device type in turns; print one line a rank."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=2, help="turns of (cuda, cpu)")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data.svm_datasets import make_dataset, partition
    from repro_torch.kernels import _build

    _build.build()  # before any rank starts: no rank runs nvcc
    ds = make_dataset("reuters", scale=1.0, seed=0, sparse=True)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        X_te = ds.X_test
        pad = -X_te.shape[0] % args.world
        parts, y_parts, counts = partition(ds.X_train, ds.y_train, args.world, seed=0)
        np.savez(work / f"data_{args.world}.npz", cols=parts.cols, vals=parts.vals, y=y_parts,
                 counts=counts, d=parts.d, block_bound=parts.block_bound(1),
                 test_cols=np.pad(X_te.cols, ((0, pad), (0, 0))),
                 test_vals=np.pad(X_te.vals, ((0, pad), (0, 0))),
                 test_rows=X_te.shape[0] + pad)
        for turn in range(args.repeat):
            for device_type in ("cuda", "cpu"):
                t0 = time.perf_counter()
                ranks = cs.run_mesh(args.world, "gloo", work, device_type=device_type)
                for r in ranks:
                    print(f"{device_type} turn {turn} rank {r['rank']}: "
                          f"{r['us_per_step']:.1f} us a step, {r['exchange_share']:.3f} "
                          f"exchanging, {r['exchanges']} exchanges, host_staged_bytes "
                          f"{r['host_staged_bytes']}", flush=True)
                print(f"{device_type} turn {turn}: {time.perf_counter() - t0:.1f} s with "
                      "start-up", flush=True)
                out[f"{device_type}{turn}"] = [
                    {k: r[k] for k in ("rank", "us_per_step", "exchange_share", "exchanges",
                                       "host_staged_bytes")} for r in ranks]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
