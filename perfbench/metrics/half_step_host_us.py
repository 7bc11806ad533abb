"""The host's time in the program's ``gadget.half_step`` ranges of the
traced segment, an iteration: ``ops.py``'s dispatch around the half-step's
launches (argument checks, the block map's set-up, the launch). Nothing
where the program records no such range."""


def read(ctx):
    tr = ctx["trace"]
    spans = [e - s for name, s, e in tr.host if name == "gadget.half_step"]
    return 1e6 * sum(spans) / tr.iters if spans and tr.iters else None
