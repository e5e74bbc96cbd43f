"""CST rollout: the ``rl.decode`` span, ms a step (``rl/scst.py``)."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "rl.decode")
