"""The DIN attention backward's share of its roofline over the traced calls:
the least time at each traced step's shape and unmasked positions
(``bounds.din_backward_bound``) over the device time of the kernels whose
names match ``attention.bwd_roofline/*.json`` (the pack, the row terms,
the backward kernel and the reduction)."""
from port_bench import bounds


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.traced_steps()
    if not steps or "positions" not in steps[0]:
        return None
    ms = ctx.trace.device_ms(ctx.patterns())
    if ms <= 0:
        return None
    least = sum(bounds.din_backward_bound(s["batch"], s["T"], s["K"], s["H1"], s["H2"],
                                          s["positions"])[0] for s in steps)
    return 100.0 * least / ms
