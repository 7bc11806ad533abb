"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's data are made on the card from the seed (``gen.py``). Set-up
builds the program's GADGET stream (``repro_torch.core.gadget.
gadget_train_stream``, its own draws, ``segment_iters`` from the traffic
mix, epsilon 0 and no iteration cap, so the stream runs the whole window)
and drives it through the mix's warm-up segments, the first of them from
zero weights; that builds and loads every kernel and warms every shape.
The window then pulls segments from the same stream until ``--seconds``
have passed: every segment ends in the program's host sync, so the window
ends when the device has finished the last one. ``train_samples_per_s`` is
m * B rows an iteration, over every iteration the window ran, over its
wall time; ``setup_s`` is the time from the start of this process to the
window.

With ``--trace 1`` two more segments run after the window under
torch.profiler: the first as it is, for the device's busy and idle time
and its launches; the second with the benchmark's spans around the calls
into each layer (``trace.spans``, ``layers.json``), for the device time of
each layer. The per-layer readers (``metrics/<name>.py``) take their
numbers from those traces.

Then the program's state is left for the reference (``check.py``), which
follows the first segment and the window's last one, and the run prints
the numbers compared with their limits, last on standard error and last in
the result line, whose other keys are ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` and, traced, ``breakdown``. Without a
CUDA card, or without the program beside this folder, it prints no result
and exits with 2; if JAX or the JAX package was loaded, with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SCORE_ROWS = 1024  # test rows scored a launch on ELL data
CHUNK = 50         # iterations whose draws the nnz count makes together


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, flax's
    or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Planes:
    """ELL partitions on the card, as the program takes them (``.cols``,
    ``.vals``, ``.d``, and the static touched-block bound)."""

    def __init__(self, fleet):
        self.fleet, self.cols, self.vals, self.d = fleet, fleet.cols, fleet.vals, fleet.d

    def block_bound(self, batch_size: int) -> int:
        from perfbench import gen
        return gen.block_bound(self.fleet, batch_size)


def seed32(seed: int) -> int:
    """The draws' seed: the program keys its streams on 32 signed bits."""
    return int(seed) % 2 ** 31


def settings(cell: spec.Cell, seed: int):
    """The reference's statement of the run."""
    from perfbench import reference as ref
    tr = cell.traffic
    faults = tr.get("faults")
    if faults is not None:
        faults = {"drop_prob": float(faults["drop_prob"]), "drop": faults["drop"],
                  "dead_nodes": tuple(faults.get("dead_nodes", ())), "seed": seed32(seed)}
    return ref.Settings(cell.config["lam"], tr["batch_size"], tr["gossip_rounds"],
                        tr["topology"], seed32(seed), faults)


def stream(cell: spec.Cell, fleet, s, dev, resume=None):
    """The program's GADGET stream over ``fleet`` as the cell states it."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.gadget import GadgetConfig, gadget_train_stream
    plan = None
    if s.faults is not None:
        plan = FaultPlan(drop_prob=s.faults["drop_prob"], drop=s.faults["drop"],
                         dead_nodes=s.faults["dead_nodes"], seed=s.faults["seed"])
    cfg = GadgetConfig(lam=s.lam, batch_size=s.B, gossip_rounds=s.R, topology=s.topology,
                       epsilon=0.0, max_iters=10 ** 12, seed=s.seed, fused=True,
                       sparse_schedule="auto", faults=plan)
    X = fleet.X if fleet.X is not None else Planes(fleet)
    return gadget_train_stream(X, fleet.y, cfg, segment_iters=cell.traffic["segment_iters"],
                               n_counts=fleet.counts.cpu().numpy(), device=dev,
                               resume=resume)


def program_scores(w, test):
    """The program's test scores of the consensus ``w`` (its serving kernels)."""
    import torch
    from repro_torch.kernels.hinge_subgrad import ops
    if test.X is not None:
        return ops.dense_predict(w, test.X)[0]
    return torch.cat([ops.ell_predict(w, test.cols[i:i + SCORE_ROWS], test.vals[i:i + SCORE_ROWS])[0]
                      for i in range(0, test.cols.shape[0], SCORE_ROWS)])


def schedule_note(cell: spec.Cell, fleet) -> str:
    """Which ELL kernel pair the program's ``auto`` picks at this shape."""
    if fleet.X is not None:
        return "dense: fleet_half_step"
    from perfbench import gen
    from repro_torch.kernels.hinge_subgrad import ops
    B = cell.traffic["batch_size"]
    bound = gen.block_bound(fleet, B)
    pick = ops.resolve_ell_schedule("auto", B=B, k=fleet.cols.shape[-1], d=fleet.d,
                                    n_blocks_max=bound)
    return f"ell: auto -> {pick[0]} (blk_d {pick[1]}, block bound {bound})"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def compare(cell, fleet, test, s, first, prev, last):
    """The numbers compared: the first segment from zero weights, the
    window's last segment from the program's state before it, and the
    consensus after it."""
    import torch
    from perfbench import check
    seg = cell.traffic["segment_iters"]
    zeros = torch.zeros_like(first.W)
    numbers, _ = check.stage_numbers("start", fleet, s, check.Stage(
        1, seg, zeros, zeros, first.W, first.W_sum, first.objective))
    end, W_ref = check.stage_numbers("end", fleet, s, check.Stage(
        prev.iteration + 1, last.iteration - prev.iteration, prev.W, prev.W_sum, last.W,
        last.W_sum, last.objective))
    numbers.update(end)
    w = torch.from_numpy(last.w_consensus).to(first.W.device)
    got = program_scores(w, test)
    numbers.update(check.answer_numbers(fleet, test, w, got, last.W, W_ref))
    return numbers


def mean_nnz(draws, t0: int, n: int) -> float:
    """Mean nonzeros of the collapsed mixing products of iterations t0 ... t0+n-1."""
    from perfbench.cost import iteration as work
    total = 0.0
    for t in range(t0, t0 + n, CHUNK):
        c = min(CHUNK, t0 + n - t)
        total += work.mix_nnz(draws.rounds(t, c)) * c
    return total / n


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev, chips: int) -> dict:
    import torch
    on_card = dev.type == "cuda"
    return {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0}


def measure(cell: spec.Cell, seed: int, seconds: float, traced: bool, dev) -> dict:
    """Set up, run the window (and the traces), check; the result line."""
    import torch
    from perfbench import check, gen, trace
    from perfbench import reference as ref
    from perfbench.cost import iteration as work

    tr = cell.traffic
    marks = [("start", T_START), ("imports", time.perf_counter())]
    fleet, test = gen.make(cell.config, tr["m"], seed, dev)
    sync(dev)
    marks.append(("data", time.perf_counter()))
    s = settings(cell, seed)
    print(f"perfbench: {cell.name} seed {seed}: {schedule_note(cell, fleet)}", file=sys.stderr)
    run = stream(cell, fleet, s, dev)
    warm = [next(run)]
    marks.append(("first segment", time.perf_counter()))
    warm += [next(run) for _ in range(tr["warmup_segments"] - 1)]
    sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - T_START
    print("perfbench: set-up " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                                           for a, b in zip(marks, marks[1:])), file=sys.stderr)

    prev, iters = warm[-1], 0
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        g = next(run)
        iters += g.iteration - prev.iteration
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
        prev = g
    window_s = ends[-1] - t0
    segs = sorted(b - a for a, b in zip(ends, ends[1:]))
    quarters = [sum(1 for e in ends[1:] if q * window_s / 4 < e - t0 <= (q + 1) * window_s / 4)
                for q in range(4)]
    print(f"perfbench: window segments {len(segs)}, the first {ends[1] - t0:.4f} s, "
          f"median {segs[len(segs) // 2]:.4f} s, by quarter {quarters}", file=sys.stderr)
    last = g
    m, B = tr["m"], tr["batch_size"]
    result = {"correct": False, "attempted": iters, "failed": 0}

    if traced:
        def one():
            next(run)
            return tr["segment_iters"]
        plain = trace.record(one, layered=False)
        layered = trace.record(one, layered=True)
        nnz = mean_nnz(ref.Draws(s, fleet.counts), last.iteration + tr["segment_iters"] + 1,
                       layered.iters)
        ctx = {"trace": plain, "layers": layered, "nnz": nnz,
               "peak": work.peaks(device_info(dev, cell.chips)["kind"]),
               "window": {"iters": iters, "seconds": window_s},
               "shape": {"m": m, "B": B, "d": fleet.d,
                         "k": None if fleet.X is not None else fleet.cols.shape[-1]}}
        units = {e["name"]: e["unit"] for e in cell.per_layer}
        metrics = {}
        for name, read in cell.readers.items():
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        shares = {layer: layered.layer_seconds(layer) / layered.iters
                  for layer in sorted({o.layer for o in layered.ops})}
        print(f"perfbench: device seconds an iteration by layer {json.dumps(shares)}",
              file=sys.stderr)
        result["breakdown"] = trace.breakdown(plain)
    else:
        metrics = {"train_samples_per_s": {"value": iters * m * B / window_s,
                                           "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {e["name"]: metrics[e["name"]] for e in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info(dev, cell.chips)
    if traced:
        result["device"].update(busy_s=plain.busy_s, window_s=plain.window_s)
    run.close()
    del run, warm[1:]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(cell, fleet, test, s, warm[0], prev, last)
    correct, shown = check.judge(numbers, cell.limits)
    result.update(correct=correct, failed=0 if correct else iters)
    print(f"perfbench: window {iters} iterations in {window_s:.4f} s, set-up {setup_s:.4f} s, "
          f"card {power_limit() if dev.type == 'cuda' else dev.type}", file=sys.stderr)
    print("perfbench: not compared " + json.dumps(
        {k: v for k, v in numbers.items() if k not in shown}), file=sys.stderr)
    for name, c in shown.items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.load(args.workload, ROOT)
    except spec.SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no program (src/repro_torch) under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
