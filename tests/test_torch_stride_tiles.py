"""The stride kernel's selection and workspace, on the CPU.

The kernel (csrc/decode_stride.cu) leaves, per row and 64-column logits
tile, (max, sum of exps, best selection value, its id, its logit), and
merges them across the tiles into the token and its logprob. Its plain
version here (``tile_partials`` / ``merge_partials``) must equal argmax and
logsumexp over the whole row: ties, within a tile and across tile edges,
go to the lowest id, and -1e9 (masked) columns take no part. The workspace
sizes (``stride_workspace``, which the kernel checks) are counted by hand.
"""

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu_torch.ops.decode_stride import (
    NEG,
    TILE_N,
    stride_workspace,
)

torch.set_num_threads(1)


def tile_partials(logits, sel, tile: int = TILE_N):
    """The kernel's per-tile selection partials: for each row of ``logits``
    / ``sel`` [R, V] and each ``tile``-column block, (max, sum of
    exp(logit - max), best selection value, its id, its logit), the best
    being the first column of the largest value."""
    R, V = logits.shape
    n = -(-V // tile)
    pad = n * tile - V
    lg = torch.nn.functional.pad(logits, (0, pad), value=-torch.inf)
    sv = torch.nn.functional.pad(sel, (0, pad), value=-torch.inf)
    lg, sv = lg.view(R, n, tile), sv.view(R, n, tile)
    mx = lg.amax(dim=-1)
    sums = torch.exp(lg - mx[..., None]).sum(dim=-1)
    arg = sv.argmax(dim=-1)              # the first of equal maxima
    best = torch.gather(sv, -1, arg[..., None])[..., 0]
    ids = arg + torch.arange(n, device=arg.device) * tile
    return mx, sums, best, ids, torch.gather(lg, -1, arg[..., None])[..., 0]


def merge_partials(mx, sums, best, ids, best_logit):
    """Merge ``tile_partials`` across the tiles as the kernel does ->
    (token [R], logprob [R]): the largest selection value, ties to the lower
    id, and its logit minus the logsumexp."""
    top = best.amax(dim=-1, keepdim=True)
    cand = torch.where(best == top, ids, torch.iinfo(ids.dtype).max)
    tile = cand.argmin(dim=-1, keepdim=True)
    m = mx.amax(dim=-1, keepdim=True)
    lse = m[:, 0] + torch.log((sums * torch.exp(mx - m)).sum(dim=-1))
    token = torch.gather(ids, -1, tile)[:, 0]
    return token, torch.gather(best_logit, -1, tile)[:, 0] - lse


def _row_logits(V, seed, ties=(), masked=(), noise=False, T=1.0):
    """[6, V] logits from a seed; ``ties``: column pairs given the row's
    largest value + 1 (so they tie for the argmax); ``masked``: columns set
    to -1e9; ``noise``: the selection is logits / T + Gumbel noise."""
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy(rng.normal(size=(6, V)).astype(np.float32))
    for a, b in ties:
        top = lg.max(dim=-1).values + 1.0
        lg[:, a] = top
        lg[:, b] = top
    lg[:, list(masked)] = NEG
    sel = lg
    if noise:
        g = torch.from_numpy(rng.gumbel(size=(6, V)).astype(np.float32))
        sel = lg / T + g
        for a, b in ties:   # plant the ties in the selection values too
            top = sel.max(dim=-1).values + 1.0
            sel[:, a] = top
            sel[:, b] = top
    return lg, sel


CASES = {
    "random": dict(V=301),
    "whole_tiles": dict(V=4 * TILE_N),
    "one_tile": dict(V=40),
    "tie_across_tile_edge": dict(V=300, ties=[(TILE_N - 1, TILE_N)]),
    "tie_far_apart": dict(V=300, ties=[(5, 290)]),
    "tie_in_one_tile": dict(V=300, ties=[(70, 71)]),
    "masked_columns": dict(V=300, masked=(0, 1, 2, 64, 65, 299)),
    "masked_tile": dict(V=300, masked=tuple(range(TILE_N, 2 * TILE_N))),
    "sampled_lane": dict(V=301, noise=True, T=0.7),
    "sampled_tie_across_edge": dict(V=301, noise=True,
                                    ties=[(2 * TILE_N - 1, 2 * TILE_N)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_argmax_and_logsumexp(case):
    c = dict(CASES[case])
    V = c.pop("V")
    lg, sel = _row_logits(V, seed=len(case), **c)
    token, logprob = merge_partials(*tile_partials(lg, sel))
    want = torch.argmax(sel, dim=-1)              # the first maximum
    assert torch.equal(token, want)
    for a, _ in c.get("ties", ()):
        assert bool((token == a).all())           # the lower id of the tie
    ref = torch.gather(lg, -1, want[:, None])[:, 0] - torch.logsumexp(lg, -1)
    torch.testing.assert_close(logprob, ref, rtol=1e-6, atol=1e-5)
    assert not bool(torch.isin(token, torch.tensor(c.get("masked", ())))
                    .any())


@pytest.mark.parametrize("tile", [1, 7, TILE_N, 1000])
def test_merge_does_not_depend_on_the_tile_width(tile):
    lg, sel = _row_logits(301, seed=3, ties=[(10, 200)], noise=True)
    token, logprob = merge_partials(*tile_partials(lg, sel, tile))
    want_tok, want_lp = merge_partials(*tile_partials(lg, sel, 301))
    assert torch.equal(token, want_tok)
    torch.testing.assert_close(logprob, want_lp, rtol=1e-6, atol=1e-5)


def test_workspace_at_the_serve_shape():
    # msrvtt widths, capacity 32, K=2: R = 96 rows, 141 logits tiles,
    # q in 2 split-K slices of 256, layer-0 gates (1024 + 512 deep) in 6
    ws = stride_workspace(G=3, B=32, E=512, Em=512, A=256, H=512, L=1,
                          V=9000)
    assert ws == {"part": 4 * 96 * 141, "part_id": 96 * 141,
                  "q": 2 * 96 * 256, "gates": 6 * 96 * 2048,
                  "x": 96 * 1024, "h": 96 * 512, "c": 96 * 512,
                  "finished": 96, "token": 96}
    assert sum(ws.values()) == 1_493_280


def test_workspace_at_a_small_shape():
    # R = 6 rows, 2 tiles, one slice each; every region rounded up to 4
    ws = stride_workspace(G=2, B=3, E=5, Em=7, A=3, H=6, L=2, V=70)
    assert ws == {"part": 48, "part_id": 12, "q": 20, "gates": 144,
                  "x": 72, "h": 72, "c": 72, "finished": 8, "token": 8}
