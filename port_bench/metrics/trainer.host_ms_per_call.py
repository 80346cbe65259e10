"""The host's ms inside a ``multi_step`` call, no synchronise: copying the
call's inputs and steps' scalars into the graph's tensors and launching the
replay. Mean of the calls issued after the window with the device drained
first (in the window the host runs ahead until the launch queue is full,
and then each call waits for the device)."""
import statistics


def read(ctx):
    return statistics.fmean(ctx.host_ms) if ctx.host_ms else None
