"""The whole step's share of the card's peak: the model FLOPs of every step
the window ran (the towers' and the scorer's GEMMs over the unmasked
positions, forward and backward, no recomputation: ``models/<model>.py``
``step_flops``) over the window's time times the peak of the precision the
configuration states (its ``peak_flops``)."""


def read(ctx):
    flops = sum(ctx.step_flops(stats) * n for stats, n in ctx.window_steps())
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.window.seconds * ctx.config["peak_flops"])
