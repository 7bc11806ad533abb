"""The host's own time issuing the traced segment, a device operation: the
program's ``gadget.segment`` range less its ``gadget.sync`` (the segment's
one readback, where the host waits for the device), over the kernels,
copies and sets the device ran in the segment. Nothing where the program
records no ``gadget.segment`` range."""


def read(ctx):
    tr = ctx["trace"]
    segment = sum(e - s for name, s, e in tr.host if name == "gadget.segment")
    if segment <= 0 or not tr.ops:
        return None
    sync = sum(e - s for name, s, e in tr.host if name == "gadget.sync")
    return 1e6 * (segment - sync) / len(tr.ops)
