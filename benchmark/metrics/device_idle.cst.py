"""The device's idle share of the traced window: the part not covered
by the union of its kernels, copies and sets, in percent."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
