"""The host's time in the program's ``gadget.mix`` ranges of the traced
segment, an iteration: the Push-Sum mix's calls. Nothing where the program
records no such range."""


def read(ctx):
    tr = ctx["trace"]
    spans = [e - s for name, s, e in tr.host if name == "gadget.mix"]
    return 1e6 * sum(spans) / tr.iters if spans and tr.iters else None
