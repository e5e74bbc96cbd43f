"""The whole CST step's share of the bf16 peak: the decode's kernel-2
launches (K rows a clip a step) and encoder passes, and the updates."""

from benchmark import work
from benchmark.readers import mfu_pct


def read(ctx):
    s, d, B = ctx["session"], ctx["dims"], ctx["cell"].batch
    K = ctx["cell"].rl_config().num_rollouts
    enc, tok = work.enc_and_per_tok_flops(d)
    launches = s.counters.get("fused_decode_step", 0)
    flops = (s.steps * (B * enc + work.update_flops(d, B, K))
             + launches * K * B * tok)
    return mfu_pct(ctx, flops)
