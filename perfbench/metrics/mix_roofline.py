"""The collapsed Push-Sum mix's least time by the frozen model
(``cost.iteration.mix``: n_i W_half and the masses read, the product's
nonzeros read, values and weights written; 2 nnz (d + 1) operations) over
the device time of the operations launched from ``push_sum.mix_*``, an
iteration. ``nnz`` is the mean over the traced iterations' own draws."""
from perfbench.cost import iteration as work


def read(ctx):
    peak, tr = ctx["peak"], ctx["layers"]
    seconds = tr.layer_seconds("mix") / tr.iters if tr.iters else 0.0
    if peak is None or seconds <= 0 or ctx.get("nnz") is None:
        return None
    s = ctx["shape"]
    return 100.0 * work.least_seconds(work.mix(s["m"], s["d"], ctx["nnz"]), peak) / seconds
