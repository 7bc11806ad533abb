"""Train → snapshot → serve: the GADGET anytime loop end to end, on the
PyTorch/CUDA port.

GADGET's consensus model is usable at every iteration. This demo trains a
CCAT-shaped sparse SVM for a few dozen iterations with the anytime export
ring enabled, checkpoints the latest snapshot (f32 and int8+scale), then
stands up a ``repro_torch.serve.SvmServer`` and pushes ragged sparse queries
through the bucketed micro-batcher — variable-nnz requests, a fixed set of
pad shapes, and touched-block sparse scoring that reads only the w d-blocks
each batch actually hits.

The twin of ``examples/serve_batched.py`` on ``repro_torch``: the same data,
configs and printed lines. On the CUDA card (the default) training runs the
sparse kernel pair ``schedule="auto"`` picks, every drained batch one
``ell_scores_prefetch`` launch and each dense ``score`` one ``dense_scores``
launch; ``--device cpu`` runs their plain PyTorch versions.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch import serve
from repro_torch._device import resolve_device
from repro_torch.core.gadget import GadgetConfig, gadget_train
from repro_torch.data.svm_datasets import make_dataset, partition

SCALE, N_NODES, N_QUERIES, DRAIN_AT = 0.003, 4, 64, 16


def train(device=None, scale: float = SCALE):
    """CCAT-shaped ELL planes at full width, 4 nodes, 60 iterations with a
    snapshot every 15: (dataset, partitions, result)."""
    ds = make_dataset("ccat", scale=scale, seed=0, sparse=True)  # CCAT shape
    Pe, yp, nc = partition(ds.X_train, ds.y_train, N_NODES, seed=0)
    cfg = GadgetConfig(lam=ds.lam, batch_size=4, gossip_rounds=4,
                       max_iters=60, check_every=30, epsilon=0.0)
    t0 = time.time()
    res = gadget_train(Pe, yp, cfg, n_counts=nc, snapshot_every=15, device=device)
    print(f"trained {res.iters} iters in {time.time()-t0:.1f}s "
          f"(d={ds.d}, k_max={ds.X_train.k_max})")
    for s in serve.snapshots_from(res):
        print(f"  snapshot @ iter {s.iteration:4d}  objective {s.objective:.4f}")
    return ds, Pe, res


def export_and_serve(ds, Pe, res, root: str, device=None, n_queries: int = N_QUERIES) -> dict:
    """Export the latest snapshot f32 and int8 under ``root``, serve
    ``n_queries`` ragged test queries through the calibrated buckets
    (drained every ``DRAIN_AT``), then hold the int8 replica's labels
    against f32 on 32 dense queries. Returns what was served."""
    snap = serve.latest(res)
    # --- checkpoint (versioned manifest; int8 is 4x smaller at rest) ------
    path = serve.to_checkpoint(snap, root + "/f32", lam=ds.lam)
    serve.to_checkpoint(snap, root + "/int8", quantize="int8", lam=ds.lam)
    print(f"exported f32 + int8 checkpoints ({path.rsplit('/', 2)[-2]})")

    # --- serve: bucketed micro-batching over ragged sparse queries --------
    srv = serve.SvmServer.load(root + "/f32", device=device)
    k_max = ds.X_test.k_max
    buckets = serve.calibrate_buckets(
        serve.bucket_ladder(k_max, rows=8, min_k=max(8, k_max // 4), d=ds.d),
        Pe.cols.reshape(-1, Pe.cols.shape[-1])[:2000],
        Pe.vals.reshape(-1, Pe.vals.shape[-1])[:2000], ds.d)
    print("buckets:", [(b.rows, b.k, b.n_blocks_max) for b in buckets])
    mb = serve.MicroBatcher(buckets)

    queries, results = [], {}
    for i in range(n_queries):  # ragged: some queries truncated
        live = ds.X_test.vals[i] != 0
        nnz = int(live.sum()) if i % 2 else max(1, int(live.sum()) // 3)
        queries.append((ds.X_test.cols[i][live][:nnz], ds.X_test.vals[i][live][:nnz]))
        mb.submit(*queries[-1])
        if mb.pending >= DRAIN_AT:
            results.update(mb.drain(srv.scorer_for()))
    results.update(mb.drain(srv.scorer_for()))

    st, sv = mb.stats(), srv.stats()
    print(f"served {st['requests']} queries in {st['batches']} batches: "
          f"p50 {st['latency_p50_ms']:.0f}ms  p99 {st['latency_p99_ms']:.0f}ms  "
          f"{st['queries_per_sec']:.1f} q/s")
    print(f"compiled {sv['distinct_shapes']} shapes for {len(buckets)} buckets; "
          f"sparse scoring touched {sv['blocks_visited_ratio']:.1%} of w blocks")

    # --- quantized replica agrees on labels ------------------------------
    srv_q = serve.SvmServer.load(root + "/int8", device=device)
    Xq = ds.X_test.take_rows(np.arange(32)).to_dense()
    s_f32, l_f32 = srv.score(Xq)
    _, l_int8 = srv_q.score(Xq)
    agree = float(np.mean(l_f32 == l_int8))
    print(f"int8 vs f32 label agreement on 32 queries: {agree:.1%}")
    assert agree >= 0.9
    return {"queries": queries, "results": results, "buckets": buckets, "batcher": st,
            "server": sv, "dense_scores": s_f32, "labels_f32": l_f32, "labels_int8": l_int8,
            "agree": agree}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # --- train with the anytime export ring riding the loop --------------
    ds, Pe, res = train(dev)
    with tempfile.TemporaryDirectory(prefix="torch_serve_batched_") as td:
        export_and_serve(ds, Pe, res, td, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
