"""The 95th percentile, over every call of the window, of the time from one
call's completion to the next's, over K: CUDA events recorded after each
call with no synchronise between, read once the window has closed, so a
stall of the host between calls counts. A tail a synchronous multi-card
job feels as stragglers."""
from port_bench import harness


def read(ctx):
    ms = ctx.window.step_ms
    return harness.percentile(ms, 95) if ms else None
