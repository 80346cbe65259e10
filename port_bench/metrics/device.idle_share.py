"""The device's idle share over the traced slice: 1 - the union of its
kernel, copy and set intervals over the slice's span, from the second
traced call's start on the host to the device's last operation (the device
drained before the first call)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.span_ms <= 0:
        return None
    busy = ctx.trace.busy_ms()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.span_ms)
