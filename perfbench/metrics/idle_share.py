"""Share of the traced window in which no kernel, copy or set ran on the
device: one minus the union of their intervals over the window."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
