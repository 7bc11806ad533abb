"""Read the numbers that the limits of ``correct`` are set from, in one
process for many seeds (set-up is long, so the benchmark's own runs never
run this):

* sound runs: the program trains each seed for about as many iterations as
  a window runs (``--iters``), and the numbers are read as a run reads them;
* the witness, on every seed: the reference with its margins summed in
  float64, put in the program's place: a second sound rounding;
* the control, on the first ``--controls`` seeds: the reference itself,
  computed with every product's operands in TF32 (the precision below the float32 the
  configurations state), put in the program's place for both stages;
* the planted faults of ``faults.py``, on the same seeds: the program with
  each fault, over the first segment from zero and over the last segment
  from the sound run's state before it.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --iters 20000 \
        [--controls 3] [--out build/readings.jsonl]

Each reading is one JSON line on standard output (and in ``--out``); the
last line gives, for every number, the largest sound reading and the
smallest control and fault readings. Every line names the card it was read
on; without a CUDA card the tool reads nothing and exits with 2. A fault
that the cell cannot have (``faults.applies``) is not planted.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import run, spec  # noqa: E402


def in_place(cell, fleet, test, s, prev, *, low: bool = False,
             margins64: bool = False) -> dict:
    """The numbers of the reference put in the program's place: in TF32 (the
    control), or with its margins summed in float64 (a second sound
    rounding, which shows what rounding alone does to the numbers)."""
    import torch
    from perfbench import check
    from perfbench import reference as ref
    seg = cell.traffic["segment_iters"]
    how = dict(low=low, margins64=margins64)
    zeros = torch.zeros_like(prev.W)
    W1, S1 = ref.segment(fleet, s, zeros, zeros, 1, seg, **how)
    obj1 = ref.objective(fleet, ref.consensus(fleet, W1), s.lam)
    numbers, _ = check.stage_numbers("start", fleet, s, check.Stage(1, seg, zeros, zeros, W1, S1, obj1))
    W2, S2 = ref.segment(fleet, s, prev.W, prev.W_sum, prev.iteration + 1, seg, **how)
    w2 = ref.consensus(fleet, W2)
    end, W_ref = check.stage_numbers("end", fleet, s, check.Stage(
        prev.iteration + 1, seg, prev.W, prev.W_sum, W2, S2, ref.objective(fleet, w2, s.lam)))
    numbers.update(end)
    got = ref.scores(w2, test.X, test.cols, test.vals, low=low).float()
    numbers.update(check.answer_numbers(fleet, test, w2, got, W2, W_ref))
    return numbers


def faulted(cell, fleet, test, s, dev, prev, name) -> dict:
    """The numbers of the program with fault ``name`` planted."""
    from perfbench import faults
    from repro_torch.core.gadget import TrainState
    with faults.planted(name):
        first = next(run.stream(cell, fleet, s, dev))
        last = next(run.stream(cell, fleet, s, dev, resume=TrainState(
            prev.iteration, prev.W, prev.W_sum)))
    return run.compare(cell, fleet, test, s, first, prev, last)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--iters", type=int, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", default="unchanged,half_batch,no_mix,altered")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("readings: the limits are read on a CUDA card; none is present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from perfbench import faults, gen
    cell = spec.load(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    card = run.power_limit()
    seg = cell.traffic["segment_iters"]
    out = open(args.out, "a") if args.out else None
    lower: dict = {}
    upper: dict = {}

    def emit(row: dict) -> None:
        line = json.dumps({**row, "card": card})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        fleet, test = gen.make(cell.config, cell.traffic["m"], seed, dev)
        s = run.settings(cell, seed)
        stream = run.stream(cell, fleet, s, dev)
        first = prev = next(stream)
        while prev.iteration + seg < args.iters:
            prev = next(stream)
        last = next(stream)
        stream.close()
        numbers = run.compare(cell, fleet, test, s, first, prev, last)
        emit({"workload": cell.name, "seed": seed, "kind": "sound", "iteration": last.iteration,
              "seconds": time.perf_counter() - t, "numbers": numbers})
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, 0.0), v)
        emit({"workload": cell.name, "seed": seed, "kind": "witness",
              "numbers": in_place(cell, fleet, test, s, prev, margins64=True)})
        if i >= args.controls:
            continue
        kinds = [("control", lambda: in_place(cell, fleet, test, s, prev, low=True))]
        kinds += [(f"fault:{f}", lambda f=f: faulted(cell, fleet, test, s, dev, prev, f))
                  for f in args.faults.split(",") if f and faults.applies(f, cell.traffic)]
        for kind, fn in kinds:
            numbers = fn()
            emit({"workload": cell.name, "seed": seed, "kind": kind, "numbers": numbers})
            for k, v in numbers.items():
                upper.setdefault(kind, {})[k] = min(upper.get(kind, {}).get(k, float("inf")), v)
    emit({"workload": cell.name, "kind": "summary", "lower": lower, "upper": upper})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
