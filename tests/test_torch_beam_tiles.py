"""The beam-step kernel's selection partials and their merge, on the CPU.

The kernel (csrc/beam_step.cu, with the logits GEMM of csrc/step.cuh)
writes no logits. Its logits epilogue leaves, per lane row and 64-column
tile, the masked logits' max, the sum of exp(masked - max) and the tile's
top W (value, column), value descending and then the lower column; a merge
launch folds a lane's tiles into its logsumexp and its top W, emits
``score + (logit - lse)`` for live lanes and the PAD-only closed form for
finished ones, and takes the row's top W over the W x W candidates, ties
toward the lower flat id. Its plain version here (``tile_partials`` /
``merge_partials``) must equal ``beam_topk_plain``: ties inside a tile and
across tile edges, masking, finished lanes, W = 1, 5 and 16, and a vocab
that is not a multiple of 64. The workspace size (``beam_workspace``,
which the kernel checks) is counted by hand.
"""

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_topk_plain,
    beam_workspace,
)
from cst_captioning_tpu_torch.ops.decode_stride import NEG, TILE_N

torch.set_num_threads(1)


def _ahead_sort(vals, cols):
    """Sort the last axis by value descending, then the lower column."""
    order = torch.argsort(cols, dim=-1, stable=True)
    vals, cols = torch.gather(vals, -1, order), torch.gather(cols, -1, order)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)
    return torch.gather(vals, -1, order), torch.gather(cols, -1, order)


def tile_partials(logits, t: int, min_len: int, W: int, tile: int = TILE_N):
    """The logits epilogue's partials for ``logits`` [R, V]: per row and
    ``tile``-column block (max, sum of exp(masked - max), top-W values
    [.., W], their columns [.., W]); masked: PAD, BOS and, while
    t < min_len, EOS at -1e9; columns past V at -inf with column
    2^31 - 1."""
    R, V = logits.shape
    x = logits.clone()
    x[:, PAD_ID] = NEG
    x[:, BOS_ID] = NEG
    if t < min_len:
        x[:, EOS_ID] = NEG
    n = -(-V // tile)
    x = torch.nn.functional.pad(x, (0, n * tile - V), value=-torch.inf)
    x = x.view(R, n, tile)
    cols = torch.arange(n * tile).view(n, tile).expand(R, n, tile).clone()
    cols[cols >= V] = torch.iinfo(torch.int32).max
    mx = x.amax(dim=-1)
    sums = torch.exp(x - mx[..., None]).sum(dim=-1)
    vals, ids = _ahead_sort(x, cols)
    if tile < W:   # a list shorter than W fills up with (-inf, 2^31 - 1)
        vals = torch.nn.functional.pad(vals, (0, W - tile), value=-torch.inf)
        ids = torch.nn.functional.pad(ids, (0, W - tile),
                                      value=torch.iinfo(torch.int32).max)
    return mx, sums, vals[..., :W], ids[..., :W]


def merge_partials(parts, finished, scores, V: int):
    """The merge launch on ``tile_partials`` of the [W * B] lane rows ->
    (top_scores [B, W], top_flat [B, W] int32)."""
    mx, sums, vals, ids = parts
    W, B = finished.shape
    n = mx.shape[-1]
    m = mx.amax(dim=-1, keepdim=True)
    lse = m[:, 0] + torch.log((sums * torch.exp(mx - m)).sum(dim=-1))
    # the lane's top W from its tiles' lists
    lv, lc = _ahead_sort(vals.reshape(W * B, n * W), ids.reshape(W * B, n * W))
    lv, lc = lv[:, :W].view(W, B, W), lc[:, :W].view(W, B, W)
    live_v = scores[:, :, None] + (lv - lse.view(W, B, 1))
    j = torch.arange(W)
    closed_v = scores[:, :, None] + torch.where(j == 0, 0.0, NEG)
    fin = finished[:, :, None]
    cand_v = torch.where(fin, closed_v, live_v)                  # [W, B, W]
    cand_c = torch.where(fin, j.expand(W, B, W), lc)
    flat = cand_c + torch.arange(W)[:, None, None] * V
    cand_v = cand_v.permute(1, 0, 2).reshape(B, W * W)
    flat = flat.permute(1, 0, 2).reshape(B, W * W)
    top_v, top_f = _ahead_sort(cand_v, flat)
    return top_v[:, :W], top_f[:, :W].to(torch.int32)


def _beam_case(W, B, V, seed, ties=(), lane_ties=False, fin_share=0.0):
    """Logits [W, B, V] from a seed; ``ties``: column pairs of every lane
    given the lane's largest value + 1; ``lane_ties``: lane 1 a copy of
    lane 0 with the same score (a tie across lanes)."""
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy(rng.normal(size=(W, B, V)).astype(np.float32))
    for a, b in ties:
        top = lg.amax(dim=-1) + 1.0
        lg[..., a] = top
        lg[..., b] = top
    scores = torch.from_numpy(
        (-3.0 * rng.random(size=(W, B))).astype(np.float32))
    finished = torch.from_numpy(rng.random(size=(W, B)) < fin_share)
    if lane_ties and W > 1:
        lg[1] = lg[0]
        scores[1] = scores[0]
        finished[1] = finished[0]
    return lg, finished, scores


CASES = {
    "random": dict(V=301),
    "whole_tiles": dict(V=4 * TILE_N),
    "short_last_tile": dict(V=3 * TILE_N + 3),
    "tie_in_one_tile": dict(V=300, ties=[(70, 71)]),
    "tie_across_tile_edge": dict(V=300, ties=[(TILE_N - 1, TILE_N)]),
    "tie_far_apart": dict(V=300, ties=[(5, 290)]),
    "tie_across_lanes": dict(V=300, lane_ties=True),
    "finished_lanes": dict(V=301, fin_share=0.4),
    "eos_blocked": dict(V=301, t=1, min_len=3, ties=[(EOS_ID, 40)]),
    "eos_open": dict(V=301, t=3, min_len=3, ties=[(EOS_ID, 40)]),
}


@pytest.mark.parametrize("W", [1, 5, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_the_plain_top_w(case, W):
    c = dict(CASES[case])
    V, t, min_len = c.pop("V"), c.pop("t", 0), c.pop("min_len", 0)
    B = 4
    lg, fin, scores = _beam_case(W, B, V, seed=len(case) + W, **c)
    parts = tile_partials(lg.reshape(W * B, V), t, min_len, W)
    top_v, top_f = merge_partials(parts, fin, scores, V)
    want_v, want_f = beam_topk_plain(lg, fin, scores, t=t, min_len=min_len)
    assert torch.equal(top_f, want_f)
    torch.testing.assert_close(top_v, want_v, rtol=1e-6, atol=1e-5)
    tok = top_f % V
    assert not bool(((tok == BOS_ID) & (top_v > NEG / 2)).any())
    if t < min_len:
        assert not bool(((tok == EOS_ID) & (top_v > NEG / 2)).any())
    # a live lane's planted tie keeps the lower column first
    for a, b in c.get("ties", ()):
        if (a == EOS_ID and t < min_len) or W < 2:
            continue
        live = ~fin.T                                          # [B, W]
        for row in range(B):
            if not bool(live[row].any()):
                continue
            got = top_f[row].tolist()
            g = int(live[row].nonzero()[0, 0])
            if g * V + b in got:
                assert g * V + a in got
                assert got.index(g * V + a) < got.index(g * V + b)


@pytest.mark.parametrize("tile", [1, 7, TILE_N, 1000])
def test_merge_does_not_depend_on_the_tile_width(tile):
    W, V = 5, 301
    lg, fin, scores = _beam_case(W, 3, V, seed=3, ties=[(10, 200)],
                                 fin_share=0.3)
    got = merge_partials(tile_partials(lg.reshape(W * 3, V), 0, 0, W, tile),
                         fin, scores, V)
    want = merge_partials(tile_partials(lg.reshape(W * 3, V), 0, 0, W, V),
                          fin, scores, V)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-5)


def test_workspace_at_the_eval_shape():
    # msrvtt_eval_beam5: W=5 lanes x B=64 rows, V=9000 in 141 tiles of 64,
    # each (max, sum of exps, 5 values, 5 columns): 2.17 MB against the
    # 11.5 MB of [W, B, V] float32 logits
    assert beam_workspace(5, 64, 9000) == 320 * 141 * 12 == 541_440
    assert beam_workspace(5, 64, 9000) * 4 < 5 * 64 * 9000 * 4 / 5


def test_workspace_at_a_small_shape():
    # W * B rows x tiles of 64 x (2 + 2W) floats: 2 x 3 rows, V=70 in 2
    # tiles, 6 floats each: 72; one row and one tile at W=1: 4; a 65th
    # column opens a second tile
    assert beam_workspace(2, 3, 70) == 72
    assert beam_workspace(1, 1, 64) == 4
    assert beam_workspace(1, 1, 65) == 8
    assert beam_workspace(3, 1, 5) == 24
    assert beam_workspace(16, 2, 129) == 32 * 3 * 34
