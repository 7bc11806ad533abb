"""The serving control plane's open loop on one CUDA card, at several
submitter ticks, in turns.

Trains the paper's CCAT run (``PAPER_RUNS["ccat"]``, ELL planes at full
width, rows cut to a tenth), calibrates phase 10's buckets, and then, for
each repeat and each ``--ticks`` value in turn (the order alternating
between repeats), runs ``chip_smoke.py`` phase 19's traced closed loop
(``closed_loop``: the capacity) and its open loop (``open_loop``: 20,000
Poisson arrivals at twice the capacity, a 1.5 s tail at half of it, the
whole protection stack) with ``chip_smoke.SUBMIT_TICK_S`` set to the tick.
For each run it prints the capacity, the goodput, the rate the submitter
reached in the burst, the ladder's rungs, the host milliseconds a
``score_sparse`` call took in the closed and in the open loop, and which
of ``open_loop``'s checks failed, if one did; one JSON line at the end.

Usage:
    python3 tools/control_plane_probe.py [--ticks 0.001,0.005] [--repeat 4]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def timed_scoring(srv) -> list:
    """Wrap ``srv.score_sparse`` so each call's host seconds are appended
    to the returned list (``scorer_for`` calls it through the instance)."""
    seconds = []
    score = srv.score_sparse

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = score(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out
    srv.score_sparse = timed
    return seconds


def main() -> int:
    """Run every tick ``--repeat`` times; one JSON line at the end."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", default="0.001,0.005",
                    help="comma-separated submitter ticks in seconds")
    ap.add_argument("--repeat", type=int, default=4)
    args = ap.parse_args()
    ticks = [float(t) for t in args.ticks.split(",")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("control_plane_probe: needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke as cs
    from repro_torch import serve, telemetry
    from repro_torch.configs.gadget_svm import PAPER_RUNS
    from repro_torch.core.gadget import gadget_train
    from repro_torch.data.svm_datasets import make_dataset, partition
    from repro_torch.kernels import _build
    from repro_torch.sparse import formats
    from repro_torch.telemetry import trace as tmtr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.build()
    dev = torch.device("cuda")
    ds = make_dataset("ccat", scale=cs.CCAT_SCALE, seed=0, sparse=True)
    parts, y_parts, n_counts = partition(ds.X_train, ds.y_train, cs.N_NODES, seed=0)
    w = gadget_train(parts, y_parts, PAPER_RUNS["ccat"].gadget, n_counts=n_counts,
                     device=dev).w_consensus.cpu().numpy()
    d, k = ds.X_test.shape[1], ds.X_test.k_max
    buckets = serve.calibrate_buckets(
        serve.bucket_ladder(k, rows=cs.SERVE_ROWS, min_k=cs.SERVE_MIN_K, d=d),
        parts.cols.reshape(-1, k)[:cs.SERVE_SAMPLE], parts.vals.reshape(-1, k)[:cs.SERVE_SAMPLE], d)
    queries = cs.ccat_queries(ds.X_test, ragged=False)
    chunks = [cs.queries_csr(queries[i:i + cs.INGEST_CHUNK_ROWS], d, formats.CSR)
              for i in range(0, len(queries), cs.INGEST_CHUNK_ROWS)]
    runs = []
    for rep in range(args.repeat):
        for tick in (ticks if rep % 2 == 0 else ticks[::-1]):
            cs.SUBMIT_TICK_S = tick
            registry = telemetry.Registry()
            srv = serve.SvmServer(w, device=dev, registry=registry)
            for b in buckets:
                srv.score_sparse(np.zeros((b.rows, b.k), np.int32),
                                 np.zeros((b.rows, b.k), np.float32), n_blocks_max=b.n_blocks_max)
            seconds = timed_scoring(srv)
            closed = cs.closed_loop(serve, srv, buckets, chunks,
                                    tmtr.RequestTracer(telemetry.Registry(), sample=1.0))
            capacity = len(queries) / closed["seconds"]
            closed_ms = 1e3 * float(np.mean(seconds))
            seconds.clear()
            run = {"tick_s": tick, "capacity_qps": capacity, "closed_score_ms": closed_ms}
            try:
                out = cs.open_loop(serve, tmtr, srv, buckets, queries, capacity, registry,
                                   lambda: None, lambda: {"ell_scores_prefetch": len(seconds)})
                run.update(failed=None, goodput_qps=out["goodput_qps"],
                           burst_submitted_qps=out["burst_submitted_qps"],
                           max_rung_burst=out["max_rung_burst"], rung_end=out["rung_end"])
            except cs.Failed as e:
                run.update(failed=str(e))
            run["open_score_ms"] = 1e3 * float(np.mean(seconds)) if seconds else None
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {str(t): {"runs": sum(r["tick_s"] == t for r in runs),
                        "passed": sum(r["tick_s"] == t and r["failed"] is None for r in runs)}
               for t in ticks}
    print(json.dumps({"card": card, "runs": runs, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
