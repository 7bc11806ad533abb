#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: the ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port, one nvcc per source, in parallel;
3. kernels: each of the four kernels against its plain PyTorch version on the
   card, at the shapes of the main path and at one ragged shape, and
   against itself (two runs, bit for bit), with times
   of the kernel, the plain version and the one PyTorch call that computes
   the same function (timed here only; the port never calls it);
4. main path: GADGET on the paper's reuters dataset at full size with the
   paper's config (10 nodes, B=1, R=4, random topology, 4000 iterations,
   fused), then the test set scored with ``dense_predict``; held to test
   accuracy >= 0.72 and final objective <= 0.50, and every launch counted;
5. unfused path: the same data with ``fused=False`` for 400 iterations,
   ``margins`` and ``grad_update`` launched m times per iteration;
6. whole path against the CPU: 200 iterations of the phase 4 config on the
   card with its draws recorded, replayed with ``device="cpu"`` (the plain
   versions), W within 1e-4 and the objective trace within 1e-5 relative;
7. a ``kernels`` JSON line and the final ``{"ok": true, ...}`` line.

It needs one CUDA card and the ``src/`` tree beside it, imports nothing of
JAX or of the JAX package, and exits non-zero without printing a result
when either is missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
KERNEL_RTOL = 1e-5          # max |kernel − plain| / max(1, max |plain|)
PATH_W_ATOL = 1e-4          # phase 6: card against CPU, 200 iterations
PATH_OBJ_RTOL = 1e-5
MIN_ACCURACY, MAX_OBJECTIVE = 0.72, 0.50
SOURCE_DIR = "src/repro_torch/kernels/hinge_subgrad/csrc"
REPLACES = {
    "fleet_half_step": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:106",
    "margins": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:63",
    "grad_update": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:151",
    "dense_scores": "src/repro/kernels/hinge_subgrad/predict.py:88",
}
# the paper's reuters run: PAPER_RUNS["reuters"] of the JAX package's
# configs/gadget_svm.py (Table 2 λ, k = 10 nodes, ε = 1e-3)
REUTERS = dict(lam=1.29e-4, batch_size=1, gossip_rounds=4, topology="random",
               epsilon=1e-3, check_every=200, max_iters=4000, seed=0)
N_NODES = 10


def log(msg: str) -> None:
    """Print one progress line at once."""
    print(msg, flush=True)


class Failed(Exception):
    """A phase's check did not hold."""


def require(ok: bool, what: str) -> None:
    """Fail the run with ``what`` unless ``ok``."""
    if not ok:
        raise Failed(what)


def device_ms(torch, fn, n: int) -> float:
    """Mean device time of one ``fn()`` over n back-to-back calls. A sleep
    kernel, twice as long as queueing the n calls took the host, holds the
    stream while they are queued, so the events time the device work and
    not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * max(0.05, 2 * host_s)))  # cycles: >= 2 GHz clock
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(cost: dict) -> tuple[float, str]:
    """Least time in ms for a ``launch_cost`` on the card, and what bounds it."""
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> tuple[float, float]:
    """Max |a − b|, absolute and relative to max(1, max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(1.0, float(b.abs().max()))


def phase_kernels(torch, K, P, ops, gen, dev) -> dict:
    """Every kernel against its plain version at the main path's shape and a
    ragged one; times at the main path's shape."""
    d = 8315  # reuters
    out = {}

    def rows(*shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).contiguous()

    def labels(*shape):
        return torch.where(torch.rand(*shape, generator=gen, device=dev) < 0.5, -1.0, 1.0)

    scal = ops.step_scalars(REUTERS["lam"], 1000, 1)

    # fleet_half_step: (m, B, d) = (10, 1, 8315) on the main path
    def fleet_case(m, B, dd):
        X, y = rows(m, B, dd), labels(m, B)
        W = 10 * torch.randn(m, dd, generator=gen, device=dev)
        mask = torch.ones(B, device=dev)
        s = ops.step_scalars(REUTERS["lam"], 1000, B)
        return (X, W, y, mask, s)
    ragged = fleet_case(3, 37, 1001)
    ragged[3][::3] = 0.0  # some rows masked out
    out["fleet_half_step"] = dict(
        main=fleet_case(N_NODES, 1, d), ragged=ragged, kernel=K.fleet_half_step, plain=K.fleet_half_step_plain,
        library=None, cost=ops.launch_cost("fleet_half_step", m=N_NODES, B=1, d=d),
        shape=f"X ({N_NODES}, 1, {d})")

    # margins and grad_update: one node's (B, d) = (1, 8315) on the unfused path
    def node_case(B, dd):
        X, y = rows(B, dd), labels(B)
        w = 10 * torch.randn(dd, generator=gen, device=dev)
        return X, w, y
    X1, w1, y1 = node_case(1, d)
    Xr, wr, yr = node_case(37, 1001)
    out["margins"] = dict(
        main=(X1, w1, y1), ragged=(Xr, wr, yr), kernel=K.margins, plain=K.margins_plain,
        library=lambda X, w, y: torch.mv(X, w),
        cost=ops.launch_cost("margins", B=1, d=d), shape=f"X (1, {d})")
    coeff1, coeffr = y1.clone(), torch.where(torch.arange(37, device=dev) % 2 == 0, yr, 0.0)
    sr = ops.step_scalars(REUTERS["lam"], 1000, 37)
    one_minus = float(np.float32(1) - np.float32(scal[0]))
    out["grad_update"] = dict(
        main=(X1, w1, coeff1, scal), ragged=(Xr, wr, coeffr, sr), kernel=K.grad_update,
        plain=K.grad_update_plain,
        library=lambda X, w, c, s: torch.addmv(w, X.t(), c, beta=one_minus, alpha=s[1]),
        cost=ops.launch_cost("grad_update", B=1, d=d), shape=f"X (1, {d})")

    # dense_scores: the reuters test set (3299, 8315) against one weight row
    Xq = rows(3299, d)
    Wq = torch.randn(1, d, generator=gen, device=dev)
    Xqr = rows(37, 1001)
    Wqr = torch.randn(3, 1001, generator=gen, device=dev)
    Wqr[2] = Wqr[0]  # classes 0 and 2 tie on every row: first occurrence wins
    out["dense_scores"] = dict(
        main=(Xq, Wq), ragged=(Xqr, Wqr), kernel=lambda X, W: P.dense_scores(X, W, n_classes=W.shape[0]),
        plain=lambda X, W: P.dense_scores_plain(X, W, n_classes=W.shape[0]),
        library=lambda X, W: torch.mm(X, W.t()),
        cost=ops.launch_cost("dense_predict", B=3299, d=d, C=1), shape=f"X (3299, {d}), W (1, {d})")

    results = {}
    for name, case in out.items():
        errs = {}
        for which in ("main", "ragged"):
            got = case["kernel"](*case[which])
            want = case["plain"](*case[which])
            torch.cuda.synchronize()
            if name == "dense_scores":
                (got, got_l), (want, _) = got, want
                require(got.shape == want.shape and got_l.dtype == torch.int32,
                        f"dense_scores shapes {tuple(got.shape)} {got_l.dtype}")
                # the in-kernel argmax is exact on the kernel's own scores
                require(torch.equal(got_l.long(), torch.argmax(got, dim=1)),
                        f"dense_scores argmax disagrees ({which})")
                if which == "ragged":
                    require(not torch.any(got_l == 2), "dense_scores tie not first occurrence")
            require(got.shape == want.shape, f"{name} shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"{name} non-finite ({which})")
            errs[which] = rel_err(got, want)
            require(errs[which][1] <= KERNEL_RTOL,
                    f"{name} {which}: kernel against plain rel err {errs[which][1]:.3e}")
        args = case["main"]
        first, again = case["kernel"](*args), case["kernel"](*args)
        if name == "dense_scores":
            first, again = torch.cat([first[0].flatten(), first[1].float()]), \
                torch.cat([again[0].flatten(), again[1].float()])
        require(torch.equal(first, again), f"{name}: two runs on the same inputs differ")
        n = 50 if name == "dense_scores" else 200
        ms = device_ms(torch, lambda: case["kernel"](*args), n)
        plain_ms = device_ms(torch, lambda: case["plain"](*args), n)
        lib_ms = (None if case["library"] is None
                  else device_ms(torch, lambda: case["library"](*args), n))
        bound_ms, bound_by = bound(case["cost"])
        results[name] = dict(max_abs_err=errs["main"][0], ragged_max_abs_err=errs["ragged"][0],
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by, shape=case["shape"])
        log(f"  {name:16s} {case['shape']}: err {errs['main'][0]:.3e} (ragged "
            f"{errs['ragged'][0]:.3e}), kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return results


def profile_iterations(torch, run) -> dict:
    """Device time by kernel and host time by operator over ``run()``, from
    torch.profiler. Only device-side events (kernels, copies) count as
    device time: an operator's row repeats the time of the kernels it
    launched. The profiler slows the host, so the caller divides the device
    time by an unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.self_device_time_total, reverse=True)
    on_host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"device_us": sum(e.self_device_time_total for e in on_device),
            "top_device": [(e.key[:70], e.count, e.self_device_time_total)
                           for e in on_device[:8]],
            "top_host": [(e.key[:70], e.count, e.self_cpu_time_total) for e in on_host[:8]]}


def reset_counts(K, P) -> None:
    """Set every kernel's launch count to 0."""
    for fn in (K.fleet_half_step, K.margins, K.grad_update, P.dense_scores):
        fn.launches = 0


def counts(K, P) -> dict:
    """Every kernel's launch count, by name."""
    return {fn.__name__: fn.launches
            for fn in (K.fleet_half_step, K.margins, K.grad_update, P.dense_scores)}


def main() -> int:
    """Run every phase; the exit code."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.gadget import (GadgetConfig, GeneratorDraws, RecordedDraws,
                                         gadget_train)
    from repro_torch.data.svm_datasets import make_dataset, partition
    from repro_torch.kernels import _build
    from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import predict as P

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    log("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = phase_kernels(torch, K, P, ops, gen, dev)

    log("phase 4: main path, reuters at full size, fused")
    t0 = time.perf_counter()
    ds = make_dataset("reuters", scale=1.0, seed=0)
    Xp, yp, n_counts = partition(ds.X_train, ds.y_train, N_NODES, seed=0)
    X_dev, y_dev = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    torch.cuda.synchronize()
    log(f"  data: train {ds.X_train.shape}, test {ds.X_test.shape}, partitions "
        f"{tuple(Xp.shape)}, {time.perf_counter() - t0:.1f} s")
    cfg = GadgetConfig(**REUTERS)
    gadget_train(X_dev, y_dev, cfg._replace(max_iters=20, check_every=10),
                 n_counts=n_counts, device=dev)  # warm-up: cuBLAS and the libraries
    torch.cuda.synchronize()
    reset_counts(K, P)
    t0 = time.perf_counter()
    res = gadget_train(X_dev, y_dev, cfg, n_counts=n_counts, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, pred = ops.dense_predict(res.w_consensus, Xte)
    acc = float((pred == yte).to(torch.float32).mean())
    score_s = time.perf_counter() - t0
    main_counts = counts(K, P)
    objective = float(res.objective_trace[-1])
    log(f"  {res.iters} iterations in {train_s:.3f} s ({res.iters / train_s:.1f} it/s), "
        f"objective {objective:.4f}, test accuracy {acc:.4f} (scored in {score_s * 1e3:.1f} ms), "
        f"eps {res.epsilon:.3e}, launches {main_counts}")
    require(res.W.shape == (N_NODES, ds.d) and bool(torch.isfinite(res.W).all()),
            "final W not finite or misshaped")
    require(pred.shape == (ds.X_test.shape[0],), "prediction shape")
    require(acc >= MIN_ACCURACY, f"test accuracy {acc:.4f} < {MIN_ACCURACY}")
    require(objective <= MAX_OBJECTIVE, f"objective {objective:.4f} > {MAX_OBJECTIVE}")
    require(main_counts["fleet_half_step"] == res.iters,
            f"fleet_half_step launched {main_counts['fleet_half_step']} times in {res.iters} iterations")
    require(main_counts["dense_scores"] == 1, "dense_scores not launched once for the test set")
    require(main_counts["margins"] == main_counts["grad_update"] == 0,
            "the fused path launched unfused kernels")

    n_prof = 200
    prof = profile_iterations(torch, lambda: gadget_train(
        X_dev, y_dev, cfg._replace(max_iters=n_prof), n_counts=n_counts, device=dev))
    device_us = prof["device_us"] / n_prof
    host_us = train_s / res.iters * 1e6
    busy = device_us / host_us
    log(f"  profile of {n_prof} iterations: device {device_us:.1f} us/iteration against "
        f"{host_us:.1f} us/iteration of wall time unprofiled: device busy {busy:.3f}")
    for key, count, us in prof["top_device"]:
        log(f"    device {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    for key, count, us in prof["top_host"]:
        log(f"    host   {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    require(device_us > 0, "the profiled window ran nothing on the device")

    log("phase 5: unfused path, 400 iterations")
    cfg_u = cfg._replace(fused=False, max_iters=400)
    reset_counts(K, P)
    t0 = time.perf_counter()
    res_u = gadget_train(X_dev, y_dev, cfg_u, n_counts=n_counts, device=dev)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = counts(K, P)
    log(f"  {res_u.iters} iterations in {unfused_s:.3f} s ({res_u.iters / unfused_s:.1f} it/s), "
        f"objective {float(res_u.objective_trace[-1]):.4f}, launches {unfused_counts}")
    require(bool(torch.isfinite(res_u.W).all()), "unfused W not finite")
    for name in ("margins", "grad_update"):
        require(unfused_counts[name] == N_NODES * res_u.iters,
                f"{name} launched {unfused_counts[name]} times, want {N_NODES * res_u.iters}")
    require(unfused_counts["fleet_half_step"] == 0, "the unfused path launched the fleet kernel")

    log("phase 6: whole path on the card against the CPU, 200 iterations")
    cfg_6 = cfg._replace(max_iters=200)
    live = GeneratorDraws(cfg_6.seed)
    taken = []

    class Recording:
        def take(self, t0, n, plan):
            ids, mix = live.take(t0, n, plan)
            taken.append((ids.cpu(), mix.cpu()))
            return ids, mix

    res_gpu = gadget_train(X_dev, y_dev, cfg_6, n_counts=n_counts, device=dev, draws=Recording())
    replay = RecordedDraws(torch.cat([i for i, _ in taken]), torch.cat([m for _, m in taken]))
    t0 = time.perf_counter()
    res_cpu = gadget_train(Xp, yp, cfg_6, n_counts=n_counts, device="cpu", draws=replay)
    cpu_s = time.perf_counter() - t0
    w_err = float((res_gpu.W.cpu() - res_cpu.W).abs().max())
    obj_err = float(np.max(np.abs(res_gpu.objective_trace - res_cpu.objective_trace)
                            / np.abs(res_cpu.objective_trace)))
    log(f"  W max abs err {w_err:.3e} (<= {PATH_W_ATOL}), objective rel err {obj_err:.3e} "
        f"(<= {PATH_OBJ_RTOL}), CPU run {cpu_s:.1f} s")
    require(res_gpu.iters == res_cpu.iters == 200, "iteration counts differ")
    require(w_err <= PATH_W_ATOL, f"W differs by {w_err:.3e}")
    require(obj_err <= PATH_OBJ_RTOL, f"objective trace differs by {obj_err:.3e}")

    log("phase 7: summary")
    launches = {"fleet_half_step": main_counts["fleet_half_step"],
                "dense_scores": main_counts["dense_scores"],
                "margins": unfused_counts["margins"],
                "grad_update": unfused_counts["grad_update"]}
    paths = {"fleet_half_step": "fused training (phase 4)", "dense_scores": "scoring (phase 4)",
             "margins": "unfused training (phase 5)", "grad_update": "unfused training (phase 5)"}
    sources = {"fleet_half_step": "hinge_subgrad.cu", "margins": "hinge_subgrad.cu",
               "grad_update": "hinge_subgrad.cu", "dense_scores": "predict.cu"}
    line = {"kernels": [dict(name=name, route="cuda", source=f"{SOURCE_DIR}/{sources[name]}",
                             replaces=REPLACES[name], launches=launches[name], path=paths[name],
                             tolerance=f"rel {KERNEL_RTOL}", **kernels[name])
                        for name in ("fleet_half_step", "margins", "grad_update", "dense_scores")],
            "main_path": {"iters": res.iters, "train_s": train_s, "iters_per_s": res.iters / train_s,
                          "test_accuracy": acc, "objective": objective,
                          "device_us_per_iter": device_us, "host_us_per_iter": host_us,
                          "device_busy_share": busy,
                          "unfused_iters_per_s": res_u.iters / unfused_s,
                          "cpu_parity_w_err": w_err, "cpu_parity_obj_rel_err": obj_err},
            "total_s": time.perf_counter() - t_all}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
