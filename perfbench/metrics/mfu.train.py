"""The whole iteration's least time by the frozen model
(``cost.iteration.iteration``: W and W_sum read and written, the minibatch
rows and labels read once, the mix's nonzeros; the operations these need)
over the measured time an iteration of the run's untraced window."""
from perfbench.cost import iteration as work


def read(ctx):
    peak, win = ctx["peak"], ctx["window"]
    if peak is None or not win["iters"] or ctx.get("nnz") is None:
        return None
    s = ctx["shape"]
    least = work.least_seconds(work.iteration(s["m"], s["B"], s["d"], s["k"], ctx["nnz"]), peak)
    return 100.0 * least / (win["seconds"] / win["iters"])
