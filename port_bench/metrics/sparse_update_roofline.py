"""The fused sparse update's share of its roofline over the traced calls:
the least time of each traced step's real stream (its positions and the
rows it touches; ``bounds.sparse_rows_bound`` for the configuration's
``embedding_optimizer``) over the device time of the kernels whose names
match ``sparse_update_roofline/*.json``."""
from port_bench import bounds

RULES = {"sgd": "sgd", "adagrad": "adagrad", "lazy_adam": "adam"}


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_ms(ctx.patterns())
    if ms <= 0:
        return None
    rule = RULES[ctx.config["embedding_optimizer"]["name"]]
    least = sum(bounds.sparse_rows_bound(s["stream"], s["touched"], s["dim"], rule)[0]
                for s in ctx.traced_steps())
    return 100.0 * least / ms
