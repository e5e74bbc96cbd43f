"""Kernel 2 (``ops/decode_step.py``, ``csrc/decode_step.cu``): the
least time of the window's launches over its kernels' device time."""

from benchmark import work
from benchmark.readers import roofline_pct

KERNELS = ("step_q_gemm", "step_attend", "step_gates_gemm", "step_cell",
           "step_logits")


def read(ctx):
    K = ctx["cell"].rl_config().num_rollouts
    return roofline_pct(ctx, KERNELS, "fused_decode_step",
                        lambda c: work.decode_step_work(
                            c["dims"], K, c["cell"].batch))
