"""Kernels, copies and sets the device ran in the traced window, an iteration
(torch.profiler's device events; the program's own launch counter is a
model, this is the count)."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.ops) / tr.iters if tr.iters else None
