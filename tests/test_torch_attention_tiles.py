"""The additive-attention kernel's decomposition, on the CPU.

The kernel (csrc/additive_attention.cu) launches B clusters of nE blocks
of 256 threads, a cluster a row; ``ops.attention.attention_split`` picks
nE and the column passes of each block. The row's blocks score disjoint
slots and exchange the scores through distributed shared memory, so each
slot is scored once a column group; each block writes its share of the E
columns. The row is walked in chunks of slots (512 on the card):
a warp scores a slot, lane l summing A's elements l*VEC + j + 32*VEC*k in
(k, j) order before a butterfly over the 32 lanes; the chunk's max and
its sum of exps (per thread, a warp butterfly, then the 8 warps in order)
update the running max and denominator, whose exp(old max - new max)
rescales the accumulators; the chunk's weighted memory rows go to 16
chains (the chunk's slot i on chain i % 16), summed in chain order at the
end and divided by the denominator.

``attention_tiles`` is a plain model of that, with the chunk passed in
small. It is held against ``additive_attention_f32`` and against the JAX
kernel in Pallas interpret mode (its block_m set to the chunk, so both
carry the softmax across the same chunks) at M = chunk - 1, chunk,
chunk + 1 and 2 chunk + 3, with ragged masks, masked holes and a fully
masked row, in float32 and bfloat16, at nE = 1, 2, 4 and widths nE does
not divide. Its output is bit-equal across nE and across batch
compositions (which change nE), as the kernel's fixed summation orders
promise; the GPU tests hold the kernel itself to that. The model takes
tanh and exp in float64, so its values do not depend on where an element
falls in PyTorch's vector loops.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.ops.attention_pallas import (  # graftlint: disable=GL008
    fused_additive_attention as jax_attention,
)
from cst_captioning_tpu_torch.ops.attention import (
    COL_VECS,
    NEG,
    additive_attention_f32,
    attention_split,
)

torch.set_num_threads(1)

THREADS, WARPS, CHAINS = 256, 8, 16
CHUNK = 8
A = 40
WIDTH = {torch.float32: 230, torch.bfloat16: 460}   # 4 passes, ragged last
F32_TOL = 1e-6      # float32 sums in another order
# bfloat16: a tanh that lands on the other side of a bfloat16 rounding
# moves one term of a score by 2^-8 of itself; 1e-3 of the row's largest
# value, as the card's gate (chip_smoke ROW_TOL)
ROW_TOL = 1e-3
BF16_ULP = 2.0 ** -7   # the JAX output's and the model's roundings


def _vec(dtype) -> int:
    return 16 // torch.empty((), dtype=dtype).element_size()


def _f64(fn, x):
    return fn(x.double()).float()


def _butterfly(x):
    """x [..., 32] -> every lane's warp sum, as the shuffle butterfly."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(32) ^ o]
    return x[..., 0]


def score_slots(q, v, proj, mask):
    """Scores [M] of one row: lane partials in (k, j) order, then the
    butterfly; masked slots -1e9."""
    dt = proj.dtype
    M, Aw = proj.shape
    vec = _vec(dt)
    x = (proj.float() + q.float()).to(dt).float()
    t = _f64(torch.tanh, x).to(dt).float()
    prod = t * v.float()
    lanes = torch.zeros(M, 32)
    for k in range(-(-Aw // (32 * vec))):
        for j in range(vec):
            idx = torch.arange(32) * vec + j + 32 * vec * k
            live = idx < Aw
            lanes[:, live] = lanes[:, live] + prod[:, idx[live]]
    return torch.where(mask > 0, _butterfly(lanes), torch.tensor(NEG))


def block_sum(x):
    """Sum of x [n] as the block reduces it: thread t sums t, t + 256, ...,
    then each warp's butterfly, then the warps in order."""
    per = torch.zeros(THREADS)
    for k in range(0, x.shape[0], THREADS):
        seg = x[k:k + THREADS]
        per[:seg.shape[0]] = per[:seg.shape[0]] + seg
    warps = _butterfly(per.view(WARPS, 32))
    total = torch.zeros(())
    for w in range(WARPS):
        total = total + warps[w]
    return total


def block_columns(s, mem, chunk):
    """One block's columns of one row: s [M] scores, mem [M, C] float."""
    M, C = mem.shape
    m_run = torch.tensor(-torch.inf)
    d = torch.zeros(())
    acc = torch.zeros(CHAINS, C)
    for c0 in range(0, M, chunk):
        sc = s[c0:c0 + chunk]
        m_new = torch.maximum(m_run, sc.max())
        w = _f64(torch.exp, sc - m_new)
        alpha = _f64(torch.exp, m_run - m_new)      # 0 on the first chunk
        d = d * alpha + block_sum(w)
        acc = acc * alpha
        for i in range(sc.shape[0]):
            acc[i % CHAINS] = acc[i % CHAINS] + w[i] * mem[c0 + i]
        m_run = m_new
    total = torch.zeros(C)
    for c in range(CHAINS):
        total = total + acc[c]
    return total / d


def attention_tiles(q, v, mem, proj, mask, chunk=CHUNK, n_e=0, sms=132):
    """The kernel's decomposition -> (ctx [B, E] float32, not rounded, nE):
    a row's nE blocks share its scores; block r of column group g writes
    the columns of passes (g nE + r) P to (g nE + r + 1) P."""
    B, M, E = mem.shape
    n_e, passes = attention_split(B, E, mem.element_size(), sms, n_e)
    cols = passes * COL_VECS * _vec(mem.dtype)
    out = torch.full((B, E), torch.nan)
    for b in range(B):
        s = score_slots(q[b], v, proj[b], mask[b])
        for blk in range(-(-E // cols)):        # (group, rank) in order
            lo, hi = blk * cols, min(E, (blk + 1) * cols)
            out[b, lo:hi] = block_columns(s, mem[b, :, lo:hi].float(), chunk)
    return out, n_e


def _inputs(B, M, E, dtype, seed=0, Aw=A):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Aw))
    v = rng.normal(size=(Aw,)) / np.sqrt(Aw)
    mem = np.tanh(rng.normal(size=(B, M, E)))
    proj = rng.normal(size=(B, M, Aw))
    lens = rng.integers(1, M + 1, size=(B, 1))
    mask = (np.arange(M)[None] < lens) & (rng.random((B, M)) > 0.15)
    # rows 0 and 1 score highest at their last and their middle slot, so
    # the running max moves up in a later chunk
    for b, m in ((0, M - 1), (1, M // 2)):
        proj[b, m] = 3.0 * np.sign(v) - q[b]
        mask[b, m] = True
    mask[B // 2] = False                  # fully masked: the uniform softmax
    ins = [torch.from_numpy(x.astype(np.float32)).to(dtype)
           for x in (q, v, mem, proj)]
    return ins, torch.from_numpy(mask.astype(np.float32))


def _assert_near_f32(got, ins, mask):
    ref = additive_attention_f32(*ins, mask)
    if ins[0].dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = (got - ref).abs()
        assert bool((err <= ROW_TOL * ref.abs().amax(-1, keepdim=True)
                     ).all()), float(err.max())


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
SLOTS = pytest.mark.parametrize(
    "M", [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 3])


@DTYPES
@SLOTS
@pytest.mark.parametrize("n_e", [1, 2, 4])
def test_tiles_match_kernel_numerics(dtype, M, n_e):
    ins, mask = _inputs(5, M, WIDTH[dtype], dtype, seed=M + 100 * n_e)
    got, used = attention_tiles(*ins, mask, n_e=n_e)
    assert used == n_e and not bool(got.isnan().any())
    _assert_near_f32(got, ins, mask)


@functools.cache
def _jax_out(dtype, M):
    ins, mask = _inputs(5, M, WIDTH[dtype], dtype, seed=M)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = jax_attention(*(jnp.asarray(x.float().numpy(), jd) for x in ins),
                        jnp.asarray(mask.numpy()), block_m=CHUNK)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@DTYPES
@SLOTS
def test_tiles_match_jax_kernel(dtype, M):
    """float32 within F32_TOL; bfloat16 both rounded once to bfloat16,
    within one bfloat16 ulp of the value plus ROW_TOL of the row's
    largest value (XLA's tanh and PyTorch's may round to other
    neighbours)."""
    ins, mask = _inputs(5, M, WIDTH[dtype], dtype, seed=M)
    want = _jax_out(dtype, M)
    got, _ = attention_tiles(*ins, mask)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    got = got.to(dtype).float()
    limit = BF16_ULP * want.abs() + ROW_TOL * want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= limit).all())


@DTYPES
def test_tiles_score_lanes_past_one_round(dtype):
    """A = 300: more than one 32-lane round of vectors, the last vector
    ragged."""
    ins, mask = _inputs(3, 2 * CHUNK + 3, 24, dtype, seed=11, Aw=300)
    got, _ = attention_tiles(*ins, mask)
    _assert_near_f32(got, ins, mask)


def test_tiles_fully_masked_row_is_uniform():
    ins, mask = _inputs(5, 2 * CHUNK + 3, WIDTH[torch.float32],
                        torch.float32, seed=4)
    got, _ = attention_tiles(*ins, mask)
    torch.testing.assert_close(got[2], ins[2][2].mean(0), rtol=F32_TOL,
                               atol=F32_TOL)


@DTYPES
def test_tiles_bits_do_not_depend_on_n_e(dtype):
    ins, mask = _inputs(5, 2 * CHUNK + 3, WIDTH[dtype], dtype, seed=5)
    outs = [attention_tiles(*ins, mask, n_e=n)[0] for n in (1, 2, 4)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@DTYPES
def test_tiles_bits_do_not_depend_on_batch(dtype):
    """Rows 0-4 among 9 rows, among 5, and row 3 alone: on 4 SMs the
    three batches get nE = 2, 2 and 4 (four passes need at least 2
    blocks; test_tiles_bits_do_not_depend_on_n_e takes nE = 1)."""
    ins, mask = _inputs(9, 2 * CHUNK + 3, WIDTH[dtype], dtype, seed=6)
    sub = lambda lo, hi: [x if x.ndim == 1 else x[lo:hi]  # noqa: E731
                          for x in ins] + [mask[lo:hi]]
    full, n9 = attention_tiles(*ins, mask, sms=4)
    first, n5 = attention_tiles(*sub(0, 5), sms=4)
    alone, n1 = attention_tiles(*sub(3, 4), sms=4)
    assert (n9, n5, n1) == (2, 2, 4)
    assert torch.equal(full[:5], first)
    assert torch.equal(full[3:4], alone)


def test_attention_split_counted_by_hand():
    """(nE, passes) on 132 SMs, counted by hand: a pass is 128 bfloat16 or
    64 float32 columns; nE is the larger of the power of two at or below
    ceil(264 / B) (about 2 blocks an SM) and the power of two at or above
    half the passes in E (one column group of 2 passes a block), capped at
    8 and at the passes in E, then taken down to a power of two; a block
    takes 1 pass where nE covers them all, else 2."""
    # the XE step, bfloat16: 4 passes; ceil(264/64) = 5 -> 4 blocks, 1 pass
    assert attention_split(64, 512, 2, 132) == (4, 1)
    # the update: ceil(264/320) = 1, but 4 passes need 2 blocks of 2
    assert attention_split(320, 512, 2, 132) == (2, 2)
    # float32, 8 passes: 4 blocks of 2 at B=64 and at B=320
    assert attention_split(64, 512, 4, 132) == (4, 2)
    assert attention_split(320, 512, 4, 132) == (4, 2)
    # many rows: 1 block would do for the SMs; 4 passes still need 2
    assert attention_split(5000, 512, 2, 132) == (2, 2)
    # one pass (E=19, E=72): one block whatever B
    assert attention_split(5, 19, 2, 132) == (1, 1)
    assert attention_split(5000, 19, 4, 132) == (1, 1)
    assert attention_split(64, 72, 2, 132) == (1, 1)
    # 3 passes: min(4, 3) = 3 -> 2 blocks of 2 passes
    assert attention_split(64, 384, 2, 132) == (2, 2)
    # E=700 bfloat16, 6 passes: 4 blocks of 2 cover 8
    assert attention_split(320, 700, 2, 132) == (4, 2)
    # float32 E=1024, 16 passes: 8 blocks of 2 at B=132 (fill: 2)
    assert attention_split(132, 1024, 4, 132) == (8, 2)
    # 16 and 32 passes at B=1: 8 blocks of 2, one and two column groups
    assert attention_split(1, 2048, 2, 132) == (8, 2)
    assert attention_split(1, 4096, 2, 132) == (8, 2)
    # asked: the power of two at or below the request, and at most the
    # passes in E; 1 block of 2 passes gives the update two groups
    assert attention_split(320, 512, 2, 132, n_e=1) == (1, 2)
    assert attention_split(64, 512, 2, 132, n_e=3) == (2, 2)
    assert attention_split(64, 512, 2, 132, n_e=16) == (4, 1)
    assert attention_split(1, 4096, 2, 132, n_e=8) == (8, 2)
