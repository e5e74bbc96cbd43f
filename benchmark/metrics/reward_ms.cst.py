"""CST reward: the main thread's ``rl.reward`` span, the part of the
consensus reward the pipeline does not hide, ms a step."""

from benchmark.readers import span_ms


def read(ctx):
    return span_ms(ctx, "rl.reward")
