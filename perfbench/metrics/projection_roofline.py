"""The projection after gossip's least time by the frozen model (the mixed W
read once, the projected W written once; ``cost.iteration.projection``)
over the device time of the operations the layer table puts in
``projection`` (``svm_objective.project_ball`` as the trainer calls it after
the mix), an iteration."""
from perfbench.cost import iteration as work


def read(ctx):
    peak, tr = ctx["peak"], ctx["layers"]
    seconds = tr.layer_seconds("projection") / tr.iters if tr.iters else 0.0
    if peak is None or seconds <= 0:
        return None
    s = ctx["shape"]
    return 100.0 * work.least_seconds(work.projection(s["m"], s["d"]), peak) / seconds
