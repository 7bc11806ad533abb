"""The half-step's least time by the frozen model (rows, labels and W read
once, W_half written once; ``cost.iteration.half_step``) over the device
time of the operations the layer table puts in ``half_step`` (the port's
half-step kernels and what ``ops.py`` launches around them), an iteration."""
from perfbench.cost import iteration as work


def read(ctx):
    peak, tr = ctx["peak"], ctx["layers"]
    seconds = tr.layer_seconds("half_step") / tr.iters if tr.iters else 0.0
    if peak is None or seconds <= 0:
        return None
    s = ctx["shape"]
    return 100.0 * work.least_seconds(work.half_step(s["m"], s["B"], s["d"], s["k"]), peak) / seconds
