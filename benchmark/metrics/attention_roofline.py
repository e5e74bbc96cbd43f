"""Kernel 1 (``ops/attention.py``, ``csrc/additive_attention.cu``) in
the CST update, K rollouts of each clip a launch: the least time of the
window's launches over its device time."""

from benchmark import work
from benchmark.readers import roofline_pct


def read(ctx):
    K = ctx["cell"].rl_config().num_rollouts
    return roofline_pct(ctx, ("additive_attention_kernel",),
                        "fused_additive_attention",
                        lambda c: work.attention_work(
                            c["dims"], K * c["cell"].batch))
