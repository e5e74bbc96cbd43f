"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU, at small odd shapes (V and the widths not multiples of the block
sizes, one and two LSTM layers, float32 and bfloat16 banks, a fully masked
row): the stride kernel (dense and paged; also with more live rows than
SMs, every row finished, no active row, and its workspace sizes against
the kernel's own), the additive-attention kernel
with its gradient (also over ten 512-slot chunks, at widths that take
its scalar loads or several column groups, at 1 and 320 rows, a row's
bits equal whatever batch and column split it is launched in, and a
misaligned bank), the decode-step kernel (also at one lane, greedy's
shape; rows that are not a multiple of its tiles, k segments that do not
fill a split-K slice, a row's results bit-equal whichever rows share its
tiles) and the beam-step kernel (finished lanes, EOS blocked while
t < min_len, beams of 1 and 16), the workspace sizes against the
kernels' own, and the wrappers' refusals. For the trainer: the attention
kernel at one memory slot a row (the mean-pool encoder's bank), the
prefetch thread's side-stream copies against blocking copies, and an XE
and a CST epoch of the Trainer with the kernels on. For serving: a hot
swap's mixed-version strides and lanes added by grow_capacity, each
request bit-equal to itself served alone. For RL: the strict decoupled
trainer bitwise equal to the sync loop, and the online learner updating
and publishing into a live service.
Marked ``gpu``: these skip without a CUDA device and run on the H100
(which has no jax, hence no conftest) with

    python -m pytest --noconftest tests/test_torch_cuda.py

(chip_smoke.py holds the same kernels at the full training and serving
shapes)."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.config import EOS_ID
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import decode_stride
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops import beam_step as beam_ops
from cst_captioning_tpu_torch.ops import decode_step as step_ops
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_topk_plain,
    beam_workspace,
    fused_beam_step,
    fused_beam_step_,
)
from cst_captioning_tpu_torch.ops.decode_step import (
    decode_step_plain,
    fused_decode_step,
    fused_decode_step_,
    stack_carry,
    unstack_carry,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    decode_stride_plain,
    fused_decode_stride,
    fused_decode_stride_paged,
    gather_pages,
    stride_weights,
)

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)

B, V, E, A, F, S, K, P = 6, 301, 48, 40, 11, 4, 2, 4
G = 1 + K
TOL = 1e-4   # float32 sums in another order than cuBLAS
# bfloat16 attention: the kernel against its own numerics in float32
# (additive_attention_f32), within its output's one rounding (2^-8 of the
# value) plus 1e-3 of the row's largest value (sum order, tanh)
BF16_ROUND, ROW_TOL = 2.0 ** -8, 1e-3
BF16_ULP = 2.0 ** -7   # one bfloat16 ulp, relative to the value
TIE = 1e-4    # beam candidates this close may order either way


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, layers, bank_dtype, seed=0):
    torch.manual_seed(seed)
    cfg = tcfg.ModelConfig(vocab_size=V, modalities=(("resnet", 20),),
                           d_embed=E, d_hidden=E, d_att=A,
                           encoder="temporal_attention", max_frames=F,
                           dtype="float32", num_layers=layers)
    model = CaptionModel(cfg, device=dev)
    with torch.no_grad():
        model.cell.out_proj.bias[EOS_ID] += 2.0
        feats = {"resnet": torch.randn(B, F, 20, device=dev)}
        masks = {"resnet": (torch.arange(F, device=dev)[None]
                            < torch.tensor([[1], [F], [3], [7], [F], [5]],
                                           device=dev)).float()}
        enc = model.encode(feats, masks)
    carry = tuple((c[None].expand(G, -1, -1).contiguous(),
                   h[None].expand(G, -1, -1).contiguous())
                  for c, h in enc.carry)
    g = torch.Generator().manual_seed(seed)
    token = torch.randint(3, V, (G, B), generator=g).int().to(dev)
    finished = torch.zeros((G, B), dtype=torch.bool, device=dev)
    finished[:, 4] = True
    finished[1, 2] = True
    noise = -torch.log(-torch.log(
        torch.rand((S, K, B, V), generator=g).clamp(1e-7, 1 - 1e-7))).to(dev)
    mem = enc.memory.to(bank_dtype)
    proj = enc.memory_proj.to(bank_dtype)
    lens = torch.tensor([1, F, 3, 7, F, 5], dtype=torch.int32, device=dev)
    return model, carry, token, finished, (mem, proj, enc.memory_mask), noise, lens


def _paged(bank, seed=0, B_=B):
    mem, proj, mask = bank
    width = -(-F // P)
    n = B_ * width
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed)) + 1
    pools = []
    for x in bank:
        xp = torch.nn.functional.pad(
            x, (0, 0, 0, width * P - F) if x.ndim == 3 else (0, width * P - F))
        pool = torch.zeros((n + 1, P) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        pool[order.to(x.device)] = xp.reshape((n, P) + tuple(x.shape[2:]))
        pools.append(pool)
    return (*pools, order.reshape(B_, width).int().to(mem.device))


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bank_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kernel_matches_plain(dev, layers, bank_dtype, paged):
    model, carry, token, fin, bank, noise, lens = _inputs(dev, layers,
                                                          bank_dtype)
    kw = dict(steps=S, temperature=0.8, min_len=2, mem_lens=lens)
    n_active = B - 1
    before = (fused_decode_stride.launches, fused_decode_stride_paged.launches)
    if paged:
        ins = _paged(bank)
        out = fused_decode_stride_paged(model.cell, carry, token, fin, *ins,
                                        noise, 1, n_active, **kw)
        dense = gather_pages(*ins)
    else:
        out = fused_decode_stride(model.cell, carry, token, fin, *bank, noise,
                                  1, n_active, **kw)
        dense = bank
    ref = decode_stride_plain(stride_weights(model.cell), carry, token, fin,
                              *dense, noise, 1, n_active, **kw)
    torch.cuda.synchronize()
    after = (fused_decode_stride.launches, fused_decode_stride_paged.launches)
    assert after[int(paged)] == before[int(paged)] + 1
    (kc, ktok, klp), (pc, ptok, plp) = out, ref
    assert torch.equal(ktok, ptok)
    torch.testing.assert_close(klp, plp, rtol=TOL, atol=TOL)
    live = ~(fin | (ktok == EOS_ID).any(0))
    live[:, n_active:] = False
    for (a, b), (c, d) in zip(kc, pc):
        torch.testing.assert_close(a[live], c[live], rtol=TOL, atol=TOL)
        torch.testing.assert_close(b[live], d[live], rtol=TOL, atol=TOL)
    # past the compaction prefix the carry passes through untouched
    for (a, b), (c0, h0) in zip(kc, carry):
        assert torch.equal(a[:, n_active:], c0[:, n_active:])
        assert torch.equal(b[:, n_active:], h0[:, n_active:])


def _stride_case(dev, layers, B_, K_, V_, E_=E, seed=3):
    """Stride inputs at other shapes than ``_inputs``: B_ rows, 1 + K_
    lanes, V_ tokens, widths E_, ragged clips and memory lengths, a
    float32 bank."""
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    cfg = tcfg.ModelConfig(vocab_size=V_, modalities=(("resnet", 20),),
                           d_embed=E_, d_hidden=E_, d_att=A,
                           encoder="temporal_attention", max_frames=F,
                           dtype="float32", num_layers=layers)
    model = CaptionModel(cfg, device=dev)
    G_ = 1 + K_
    frames = torch.randint(1, F + 1, (B_, 1), generator=g)
    with torch.no_grad():
        model.cell.out_proj.bias[EOS_ID] += 2.0
        enc = model.encode(
            {"resnet": torch.randn(B_, F, 20, generator=g).to(dev)},
            {"resnet": (torch.arange(F)[None] < frames).float().to(dev)})
    carry = tuple((c[None].expand(G_, -1, -1).contiguous(),
                   h[None].expand(G_, -1, -1).contiguous())
                  for c, h in enc.carry)
    token = torch.randint(3, V_, (G_, B_), generator=g).int().to(dev)
    finished = (torch.rand((G_, B_), generator=g) < 0.2).to(dev)
    noise = -torch.log(-torch.log(torch.rand(
        (S, K_, B_, V_), generator=g).clamp(1e-7, 1 - 1e-7))).to(dev)
    lens = torch.randint(1, F + 1, (B_,), generator=g).int().to(dev)
    return (model, carry, token, finished,
            (enc.memory, enc.memory_proj, enc.memory_mask), noise, lens)


# more live rows than SMs; a vocab of whole 16-byte rows whose last column
# tile is ragged; widths that are not multiples of 4 (4-byte copies); every
# row finished from the start; no active row; two layers at the wide shape
STRIDE_CASES = {
    "rows_over_sms": dict(layers=1, B_=40, K_=3, V_=V, n_active=40),
    "ragged_vocab": dict(layers=1, B_=B, K_=K, V_=300, n_active=B - 1),
    "odd_widths": dict(layers=2, B_=B, K_=K, V_=V, E_=45, n_active=B),
    "all_finished": dict(layers=1, B_=B, K_=K, V_=V, n_active=B,
                         all_finished=True),
    "n_active_0": dict(layers=1, B_=B, K_=K, V_=V, n_active=0),
    "two_layers": dict(layers=2, B_=40, K_=3, V_=V, n_active=37),
}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("case", sorted(STRIDE_CASES))
def test_stride_kernel_cases(dev, case, paged):
    c = STRIDE_CASES[case]
    model, carry, token, fin, bank, noise, lens = _stride_case(
        dev, c["layers"], c["B_"], c["K_"], c["V_"], c.get("E_", E))
    if c.get("all_finished"):
        fin = torch.ones_like(fin)
    n_active = c["n_active"]
    kw = dict(steps=S, temperature=0.9, min_len=1, mem_lens=lens)
    fn = fused_decode_stride_paged if paged else fused_decode_stride
    ins = _paged(bank, B_=c["B_"]) if paged else bank
    before = fn.launches
    kc, ktok, klp = fn(model.cell, carry, token, fin, *ins, noise, 0,
                       n_active, **kw)
    pc, ptok, plp = decode_stride_plain(
        stride_weights(model.cell), carry, token, fin,
        *(gather_pages(*ins) if paged else bank), noise, 0, n_active, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ktok, ptok)
    torch.testing.assert_close(klp, plp, rtol=TOL, atol=TOL)
    done = fin.clone()
    done[:, n_active:] = True
    assert bool((ktok[:, done] == 0).all()) and bool((klp[:, done] == 0).all())
    live = ~(done | (ktok == EOS_ID).any(0))
    for (a, b), (c_, d), (c0, h0) in zip(kc, pc, carry):
        torch.testing.assert_close(a[live], c_[live], rtol=TOL, atol=TOL)
        torch.testing.assert_close(b[live], d[live], rtol=TOL, atol=TOL)
        # rows finished from the start, or past n_active: bit for bit
        assert torch.equal(a[done], c0[done]) and torch.equal(b[done], h0[done])


def test_workspace_sizes_match_the_kernel(dev):
    lib = decode_stride._lib()
    for G_, B_, E_, Em, A_, H, L, V_ in ((3, 32, 512, 512, 256, 512, 1, 9000),
                                         (4, 40, 48, 48, 40, 48, 2, 301),
                                         (2, 1, 8, 12, 4, 16, 1, 3)):
        args = decode_stride._StrideArgs(G=G_, B=B_, E=E_, Em=Em, A=A_, H=H,
                                         L=L, V=V_)
        want = sum(decode_stride.stride_workspace(G_, B_, E_, Em, A_, H, L,
                                                  V_).values())
        assert lib.decode_stride_workspace_floats(ctypes.byref(args)) == want


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    model, carry, token, fin, bank, noise, lens = _inputs(dev, 1,
                                                          torch.float32)
    mem, proj, mask = bank
    with pytest.raises(ValueError, match="contiguous"):
        fused_decode_stride(model.cell, carry, token, fin,
                            mem.transpose(1, 2).contiguous().transpose(1, 2),
                            proj, mask, noise, steps=S)
    with pytest.raises(ValueError, match="dtype"):
        fused_decode_stride(model.cell, carry, token, fin, mem.double(),
                            proj.double(), mask, noise, steps=S)
    with pytest.raises(ValueError, match="is on"):
        fused_decode_stride(model.cell, carry, token, fin, mem, proj, mask,
                            noise.cpu(), steps=S)
    decode_stride.reset_launches()
    assert fused_decode_stride.launches == 0


# ---- the additive-attention kernel -----------------------------------------


def _attention_inputs(dev, dtype, M, seed=0):
    g = torch.Generator().manual_seed(seed)
    Bq = 5
    q = torch.randn(Bq, A, generator=g)
    v = torch.randn(A, generator=g) / A ** 0.5
    mem = torch.tanh(torch.randn(Bq, M, E, generator=g))
    proj = torch.randn(Bq, M, A, generator=g)
    lens = torch.randint(1, M + 1, (Bq, 1), generator=g)
    mask = (torch.arange(M)[None] < lens).float()
    mask[2] = 0.0                     # fully masked: the uniform softmax
    return ([x.to(dev, dtype) for x in (q, v, mem, proj)], mask.to(dev))


@pytest.mark.parametrize("M", [7, 56, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernel_matches_plain(dev, dtype, M):
    ins, mask = _attention_inputs(dev, dtype, M)
    before = fused_additive_attention.launches
    out = fused_additive_attention(*ins, mask)
    ref = additive_attention_plain(*ins, mask)
    torch.cuda.synchronize()
    assert fused_additive_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        return
    ref = additive_attention_f32(*ins, mask)
    limit = BF16_ROUND * ref.abs() + ROW_TOL * ref.abs().amax(-1, keepdim=True)
    err = (out.float() - ref).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


def test_attention_kernel_gradient(dev):
    ins, mask = _attention_inputs(dev, torch.float32, 56, seed=1)
    g = torch.randn(5, E, device=dev)
    a = [x.clone().requires_grad_() for x in ins]
    b = [x.clone().requires_grad_() for x in ins]
    before = fused_additive_attention.launches
    ga = torch.autograd.grad((fused_additive_attention(*a, mask) * g).sum(), a)
    gb = torch.autograd.grad((additive_attention_plain(*b, mask) * g).sum(), b)
    # one launch, in the forward; the backward recomputes the plain version
    assert fused_additive_attention.launches == before + 1
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_attention_wrapper_refuses(dev):
    (q, v, mem, proj), mask = _attention_inputs(dev, torch.float32, 7)
    with pytest.raises(ValueError, match="dtype"):
        fused_additive_attention(q.double(), v.double(), mem.double(),
                                 proj.double(), mask)
    with pytest.raises(ValueError, match="is on"):
        fused_additive_attention(q, v, mem, proj, mask.cpu())
    with pytest.raises(ValueError, match="do not match"):
        fused_additive_attention(q, v, mem[:, :3], proj, mask)


def _attention_bank(dev, dtype, B_, M, A_, E_, seed=0):
    """A bank of B_ rows: ragged lengths with masked holes inside them,
    the middle row fully masked."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B_, A_, generator=g)
    v = torch.randn(A_, generator=g) / A_ ** 0.5
    mem = torch.tanh(torch.randn(B_, M, E_, generator=g))
    proj = torch.randn(B_, M, A_, generator=g)
    lens = torch.randint(1, M + 1, (B_, 1), generator=g)
    mask = (torch.arange(M)[None] < lens).float()
    mask[torch.rand(B_, M, generator=g) < 0.1] = 0.0
    if B_ > 1:
        mask[B_ // 2] = 0.0
    return [x.to(dev, dtype) for x in (q, v, mem, proj)], mask.to(dev)


def _attention_close(out, ins, mask):
    """float32: the plain version within TOL; bfloat16: the kernel's own
    numerics in float32 within BF16_ROUND of the value + ROW_TOL of the
    row's largest value (as test_attention_kernel_matches_plain)."""
    if out.dtype == torch.float32:
        ref = additive_attention_plain(*ins, mask)
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        return
    ref = additive_attention_f32(*ins, mask)
    limit = BF16_ROUND * ref.abs() + ROW_TOL * ref.abs().amax(-1, keepdim=True)
    err = (out.float() - ref).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


def _attention_launch(ins, mask):
    before = fused_additive_attention.launches
    out = fused_additive_attention(*ins, mask)
    torch.cuda.synchronize()
    assert fused_additive_attention.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernel_long_bank(dev, dtype):
    """M=5000: ten chunks of 512 slots, the running max and sum carried
    across them."""
    ins, mask = _attention_bank(dev, dtype, 3, 5000, A, E, seed=2)
    out = _attention_launch(ins, mask)
    assert out.shape == (3, E) and out.dtype == dtype
    _attention_close(out, ins, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernel_long_bank_column_groups(dev, dtype):
    """M=1100 (three chunks) at E=700 launched as one block a row: its
    column groups score the row again, with the bits of the default
    split."""
    ins, mask = _attention_bank(dev, dtype, 3, 1100, A, 700, seed=7)
    out = _attention_launch(ins, mask)
    _attention_close(out, ins, mask)
    assert torch.equal(attention_ops._launch(*ins, mask, n_e=1), out)


@pytest.mark.parametrize("widths", [(100, 72), (37, 19), (24, 4100),
                                    (5000, 24)],
                         ids=["A100-E72", "A37-E19", "A24-E4100", "A5000-E24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernel_odd_widths(dev, dtype, widths):
    """Widths that are not multiples of 16 bytes take the scalar loads
    (A=100 and E=4100 in bfloat16, A=37 and E=19 in both); E=4100 needs
    more than one column group of 8 blocks x 2 passes, and A=5000 twenty
    rounds of the lanes' vectors a score."""
    A_, E_ = widths
    ins, mask = _attention_bank(dev, dtype, 5, 56, A_, E_, seed=3)
    _attention_close(_attention_launch(ins, mask), ins, mask)


@pytest.mark.parametrize("rows", [1, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernel_batch_sizes(dev, dtype, rows):
    """One row (the most column blocks a row) and the update's 320 rows,
    at the msrvtt widths."""
    ins, mask = _attention_bank(dev, dtype, rows, 56, 256, 512, seed=4)
    _attention_close(_attention_launch(ins, mask), ins, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_row_bits_do_not_depend_on_batch(dev, dtype):
    """A row's output is bit-equal launched among 320 rows, among 64 and
    alone, and at every column split nE."""
    ins, mask = _attention_bank(dev, dtype, 320, 56, 256, 512, seed=5)
    full = _attention_launch(ins, mask)
    first = _attention_launch([x if x.ndim == 1 else x[:64] for x in ins],
                              mask[:64])
    alone = _attention_launch([x if x.ndim == 1 else x[7:8] for x in ins],
                              mask[7:8])
    assert torch.equal(full[:64], first)
    assert torch.equal(full[7:8], alone)
    for n_e in (1, 2, 4, 8):   # nE=1: two column groups (four in float32)
        assert torch.equal(attention_ops._launch(*ins, mask, n_e=n_e), full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_misaligned_and_narrow_views(dev, dtype):
    """A contiguous bank whose base is not 16-byte aligned takes the
    kernel's scalar loads, with the vector loads' bits; a view narrower
    than its rows is refused. Neither reaches the plain version."""
    ins, mask = _attention_bank(dev, dtype, 5, 56, 256, 512, seed=6)
    q, v, mem, proj = ins
    buf = torch.empty(mem.numel() + 1, dtype=dtype, device=dev)
    shifted = buf[1:].view(mem.shape)
    shifted.copy_(mem)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    out = _attention_launch([q, v, shifted, proj], mask)
    assert torch.equal(out, _attention_launch(ins, mask))
    wide = torch.zeros(5, 56, 520, dtype=dtype, device=dev)
    wide[..., :512] = mem
    before = fused_additive_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        fused_additive_attention(q, v, wide[..., :512], proj, mask)
    assert fused_additive_attention.launches == before


# ---- the decode-step kernel -------------------------------------------------


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bank_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_step_kernel_matches_plain(dev, layers, bank_dtype):
    model, carry, token, _, bank, _, _ = _inputs(dev, layers, bank_dtype)
    mem, proj, mask = bank
    mask = mask.clone()
    mask[1] = 0.0                     # a fully masked row
    w = stride_weights(model.cell)
    before = fused_decode_step.launches
    kc, klog = fused_decode_step(model.cell, carry, token, mem, proj, mask)
    pc, plog = decode_step_plain(w, carry, w.embt[token.long()], mem, proj,
                                 mask)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    torch.testing.assert_close(klog, plog, rtol=TOL, atol=TOL)
    for (a, b), (c, d) in zip(kc, pc):
        torch.testing.assert_close(a, c, rtol=TOL, atol=TOL)
        torch.testing.assert_close(b, d, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_decode_step_in_place_kernel_matches_plain(dev, layers):
    # the rollout's call: a bfloat16 bank and carry, the carry stacked and
    # stepped in place; logits within TOL, the carry within TOL plus one
    # bfloat16 ulp (the kernel rounds float32 values that differ from the
    # plain version's in their last bits)
    model, carry, token, _, bank, _, _ = _inputs(dev, layers, torch.bfloat16)
    carry = tuple((c.bfloat16(), h.bfloat16()) for c, h in carry)
    w = stride_weights(model.cell)
    state = stack_carry(carry)
    before = fused_decode_step.launches
    klog = fused_decode_step_(model.cell, state, token, *bank, torch.bfloat16)
    pc, plog = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    torch.testing.assert_close(klog, plog, rtol=TOL, atol=TOL)
    kc = unstack_carry(state, torch.bfloat16)
    # the stored carry holds bfloat16 values: the cast back is exact
    assert torch.equal(state[0, 0], kc[0][0].float())
    for (a, b), (c, d) in zip(kc, pc):
        torch.testing.assert_close(a.float(), c.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)
        torch.testing.assert_close(b.float(), d.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)


def test_decode_step_wrapper_refuses(dev):
    model, carry, token, _, bank, _, _ = _inputs(dev, 1, torch.float32)
    mem, proj, mask = bank
    with pytest.raises(ValueError, match="dtype"):
        fused_decode_step(model.cell, carry, token, mem.double(),
                          proj.double(), mask)
    with pytest.raises(ValueError, match="is on"):
        fused_decode_step(model.cell, carry, token, mem, proj, mask,
                          emb=torch.zeros(G, B, E))
    with pytest.raises(ValueError, match="do not match"):
        fused_decode_step(model.cell, carry, token, mem, proj, mask[:, :3])
    with pytest.raises(ValueError, match="carry dtype"):
        fused_decode_step_(model.cell, stack_carry(carry), token, mem, proj,
                           mask, torch.float16)
    with pytest.raises(ValueError, match="carry has dtype"):
        fused_decode_step_(model.cell, stack_carry(carry).double(), token,
                           mem, proj, mask, torch.float32)


def test_decode_step_kernel_at_one_lane(dev):
    # greedy decoding's shape: G=1
    model, carry, token, _, bank, _, _ = _inputs(dev, 1, torch.bfloat16)
    carry = tuple((c[:1].bfloat16(), h[:1].bfloat16()) for c, h in carry)
    w = stride_weights(model.cell)
    state = stack_carry(carry)
    before = fused_decode_step.launches
    klog = fused_decode_step_(model.cell, state, token[:1], *bank,
                              torch.bfloat16, weights=w)
    pc, plog = decode_step_plain(w, carry, w.embt[token[:1].long()], *bank)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    assert klog.shape == (1, B, V)
    torch.testing.assert_close(klog, plog, rtol=TOL, atol=TOL)
    for (a, b), (c, d) in zip(unstack_carry(state, torch.bfloat16), pc):
        torch.testing.assert_close(a.float(), c.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)
        torch.testing.assert_close(b.float(), d.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)


# rows that are not a multiple of the 64-row tile (G=5, B=37 and one row);
# two layers; a vocab one column into a new tile; k segments that do not
# fill a 256-deep split-K slice, with the [x, h] seam inside a slice
# (E=H=200: layer-0 k = 600, layer-1 k = 400, q k = 200); widths that are
# not multiples of 4 (the tiles' 4-byte copies)
STEP_CASES = {
    "g5_b37": dict(layers=1, G_=5, B_=37, V_=V),
    "g1_b1": dict(layers=1, G_=1, B_=1, V_=V),
    "two_layers": dict(layers=2, G_=5, B_=37, V_=V),
    "vocab_257": dict(layers=1, G_=2, B_=9, V_=257),
    "ragged_split_k": dict(layers=2, G_=3, B_=23, V_=V, E_=200),
    "odd_widths": dict(layers=2, G_=2, B_=5, V_=V, E_=45),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_decode_step_kernel_cases(dev, case):
    c = STEP_CASES[case]
    model, carry, token, _, bank, _, _ = _stride_case(
        dev, c["layers"], c["B_"], c["G_"] - 1, c["V_"], c.get("E_", E))
    w = stride_weights(model.cell)
    before = fused_decode_step.launches
    kc, klog = fused_decode_step(model.cell, carry, token, *bank, weights=w)
    pc, plog = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    assert klog.shape == (c["G_"], c["B_"], c["V_"])
    torch.testing.assert_close(klog, plog, rtol=TOL, atol=TOL)
    for (a, b), (c_, d) in zip(kc, pc):
        torch.testing.assert_close(a, c_, rtol=TOL, atol=TOL)
        torch.testing.assert_close(b, d, rtol=TOL, atol=TOL)


def test_decode_step_row_does_not_depend_on_its_tile(dev):
    # the same (lane, row) inside two batches: 2 x 40 rows (two row tiles)
    # and 2 x 6 rows picked from them in another order; its logits and new
    # carry are bit-equal (every sum's order is fixed by the shapes alone)
    model, carry, token, _, bank, _, _ = _stride_case(dev, 2, 40, 1, V)
    w = stride_weights(model.cell)
    idx = torch.tensor([37, 3, 20, 11, 0, 39], device=dev)
    sub_carry = tuple((c[:, idx].contiguous(), h[:, idx].contiguous())
                      for c, h in carry)
    sub_bank = tuple(x[idx].contiguous() for x in bank)
    kc, klog = fused_decode_step(model.cell, carry, token, *bank, weights=w)
    sc, slog = fused_decode_step(model.cell, sub_carry,
                                 token[:, idx].contiguous(), *sub_bank,
                                 weights=w)
    torch.cuda.synchronize()
    assert torch.equal(klog[:, idx], slog)
    for (a, b), (c, d) in zip(kc, sc):
        assert torch.equal(a[:, idx], c) and torch.equal(b[:, idx], d)


def test_step_workspace_sizes_match_the_kernel(dev):
    slib, blib = step_ops._lib(), beam_ops._lib()
    for G_, B_, E_, Em, A_, H, V_ in ((5, 64, 512, 512, 256, 512, 9000),
                                      (1, 1, 45, 45, 40, 45, 301),
                                      (3, 23, 200, 200, 40, 200, 257)):
        sa = step_ops._StepArgs(G=G_, B=B_, E=E_, Em=Em, A=A_, H=H, V=V_,
                                L=2)
        want = sum(step_ops.step_workspace(G_, B_, E_, Em, A_, H).values())
        assert slib.decode_step_scratch_floats(ctypes.byref(sa)) == want
        ba = beam_ops._BeamArgs(step=sa)
        assert blib.beam_step_part_floats(ctypes.byref(ba)) == \
            beam_workspace(G_, B_, V_)


# ---- the beam-step kernel ---------------------------------------------------


def _assert_beam_close(ksc, kfl, psc, pfl):
    """Kernel (top_scores, top_flat) [B, W] against the plain version's
    first W + 1 candidates: flat ids equal except where the plain totals
    tie within TIE at that position (its neighbours, the (W+1)-th
    included); scores within TOL. -> rows with a near-tie difference."""
    ksc, kfl, psc, pfl = (x.cpu() for x in (ksc, kfl, psc, pfl))
    W = kfl.shape[1]
    gap = psc[:, :-1] - psc[:, 1:]                      # [B, W]
    near = gap <= TIE                                   # ties with j + 1
    near[:, 1:] |= gap[:, :W - 1] <= TIE                # ties with j - 1
    diff = kfl != pfl[:, :W]
    assert not bool((diff & ~near).any()), (kfl, pfl)
    torch.testing.assert_close(ksc, psc[:, :W], rtol=TOL, atol=TOL)
    return int(diff.any(dim=1).sum())


@pytest.mark.parametrize("t,min_len", [(0, 0), (1, 3)])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bank_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_beam_step_kernel_matches_plain(dev, layers, bank_dtype, t, min_len):
    model, carry, token, fin, bank, _, _ = _inputs(dev, layers, bank_dtype)
    scores = 2.0 * torch.randn(G, B, generator=torch.Generator()
                               .manual_seed(1)).to(dev)
    w = stride_weights(model.cell)
    before = fused_beam_step.launches
    kc, ksc, kfl = fused_beam_step(model.cell, carry, token, fin, scores,
                                   *bank, t=t, min_len=min_len)
    pc, logits = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    psc, pfl = beam_topk_plain(logits, fin, scores, t=t, min_len=min_len,
                               width=G + 1)
    torch.cuda.synchronize()
    assert fused_beam_step.launches == before + 1
    assert ksc.shape == (B, G) and kfl.dtype == torch.int32
    _assert_beam_close(ksc, kfl, psc, pfl)
    for (a, b), (c, d) in zip(kc, pc):
        torch.testing.assert_close(a, c, rtol=TOL, atol=TOL)
        torch.testing.assert_close(b, d, rtol=TOL, atol=TOL)
    if t < min_len:
        assert not bool((kfl % V == EOS_ID).any())
    # a finished lane offers PAD at its frozen score
    for g, b in fin.nonzero().tolist():
        hit = (kfl[b] == g * V).nonzero()
        if len(hit):
            assert float(ksc[b, hit[0, 0]]) == float(scores[g, b])


def test_beam_step_in_place_kernel_matches_plain(dev):
    # the search's call: a bfloat16 bank and carry stepped in place, the
    # selection partials through a workspace the search allocates once (the
    # logits themselves never reach device memory); a smaller workspace is
    # refused
    model, carry, token, fin, bank, _, _ = _inputs(dev, 2, torch.bfloat16)
    carry = tuple((c.bfloat16(), h.bfloat16()) for c, h in carry)
    scores = torch.randn(G, B, generator=torch.Generator().manual_seed(2)
                         ).to(dev)
    w = stride_weights(model.cell)
    state = stack_carry(carry)
    buf = torch.full((beam_workspace(G, B, V),), float("nan"), device=dev)
    with pytest.raises(ValueError, match="beam_workspace"):
        fused_beam_step_(model.cell, state.clone(), token, fin, scores, *bank,
                         torch.bfloat16, t=2, min_len=1, weights=w,
                         logits=buf[:-1])
    ksc, kfl = fused_beam_step_(model.cell, state, token, fin, scores, *bank,
                                torch.bfloat16, t=2, min_len=1, weights=w,
                                logits=buf)
    pc, logits = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    psc, pfl = beam_topk_plain(logits, fin, scores, t=2, min_len=1,
                               width=G + 1)
    torch.cuda.synchronize()
    assert not bool(buf.isnan().any())      # every partial written
    _assert_beam_close(ksc, kfl, psc, pfl)
    for (a, b), (c, d) in zip(unstack_carry(state, torch.bfloat16), pc):
        torch.testing.assert_close(a.float(), c.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)
        torch.testing.assert_close(b.float(), d.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)


@pytest.mark.parametrize("W", [1, 16])
def test_beam_step_kernel_widths(dev, W):
    # the narrowest and the widest beam the kernel takes, rows that are not
    # a multiple of the tile, about 20% finished lanes, EOS blocked
    B_ = 37
    model, carry, token, fin, bank, _, _ = _stride_case(dev, 1, B_, W - 1, V)
    scores = 2.0 * torch.randn(W, B_, generator=torch.Generator()
                               .manual_seed(W)).to(dev)
    w = stride_weights(model.cell)
    before = fused_beam_step.launches
    kc, ksc, kfl = fused_beam_step(model.cell, carry, token, fin, scores,
                                   *bank, t=1, min_len=2, weights=w)
    pc, logits = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    psc, pfl = beam_topk_plain(logits, fin, scores, t=1, min_len=2,
                               width=W + 1)
    torch.cuda.synchronize()
    assert fused_beam_step.launches == before + 1
    assert ksc.shape == (B_, W)
    _assert_beam_close(ksc, kfl, psc, pfl)
    assert not bool((kfl % V == EOS_ID).any())
    for (a, b), (c, d) in zip(kc, pc):
        torch.testing.assert_close(a, c, rtol=TOL, atol=TOL)
        torch.testing.assert_close(b, d, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("a,b", [(70, 71), (63, 64)],
                         ids=["in_tile", "across_tile_edge"])
def test_beam_step_kernel_exact_ties(dev, a, b):
    # columns a < b get the same Wo column and a bias that makes them every
    # lane's best, and lanes 0 and 1 are the same hypothesis at score 0
    # (the others at -50): the logits tie exactly, so the row's top four
    # must be lane 0's a, b, then lane 1's a, b (ties to the lower flat id)
    W, B_ = 5, 6
    model, carry, token, _, bank, _, _ = _stride_case(dev, 1, B_, W - 1, V)
    with torch.no_grad():
        out = model.cell.out_proj
        out.weight[b] = out.weight[a]
        out.bias[a] = out.bias[b] = out.bias.max() + 20.0
    carry = tuple((torch.cat([c[:1], c[:1], c[2:]]),
                   torch.cat([h[:1], h[:1], h[2:]])) for c, h in carry)
    token = torch.cat([token[:1], token[:1], token[2:]])
    fin = torch.zeros((W, B_), dtype=torch.bool, device=dev)
    scores = torch.full((W, B_), -50.0, device=dev)
    scores[:2] = 0.0
    w = stride_weights(model.cell)
    _, ksc, kfl = fused_beam_step(model.cell, carry, token, fin, scores,
                                  *bank, t=0, weights=w)
    _, logits = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    psc, pfl = beam_topk_plain(logits, fin, scores, t=0, min_len=0,
                               width=W + 1)
    torch.cuda.synchronize()
    want = torch.tensor([a, b, V + a, V + b], dtype=torch.int32)
    assert bool((kfl[:, :4].cpu() == want).all()), kfl
    assert torch.equal(ksc[:, 0], ksc[:, 3])
    _assert_beam_close(ksc, kfl, psc, pfl)


def test_beam_step_wrapper_refuses(dev):
    model, carry, token, fin, bank, _, _ = _inputs(dev, 1, torch.float32)
    mem, proj, mask = bank

    def lanes(n):
        return (tuple((c[:1].expand(n, -1, -1).contiguous(),
                       h[:1].expand(n, -1, -1).contiguous())
                      for c, h in carry),
                torch.full((n, B), 5, dtype=torch.int32, device=dev),
                torch.zeros((n, B), dtype=torch.bool, device=dev),
                torch.zeros((n, B), device=dev))

    with pytest.raises(ValueError, match="beam width"):
        fused_beam_step(model.cell, *lanes(V + 1), *bank, t=0)
    with pytest.raises(ValueError, match="beam width"):
        fused_beam_step(model.cell, *lanes(17), *bank, t=0)   # above 16
    c, tok, f, sc = lanes(G)
    with pytest.raises(ValueError, match="dtype"):
        fused_beam_step(model.cell, c, tok, f, sc, mem.double(),
                        proj.double(), mask, t=0)
    with pytest.raises(ValueError, match="scores"):
        fused_beam_step(model.cell, c, tok, f, sc[:1], *bank, t=0)


# ---- the trainer's data path and kernel 1 at one memory slot -------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 64, 320])
def test_attention_kernel_at_one_slot(dev, dtype, rows):
    """The mean-pool encoder's bank: one memory slot a row (M=1)."""
    g = torch.Generator().manual_seed(rows)
    q = torch.randn(rows, A, generator=g)
    v = torch.randn(A, generator=g) / A ** 0.5
    mem = torch.tanh(torch.randn(rows, 1, E, generator=g))
    proj = torch.randn(rows, 1, A, generator=g)
    mask = torch.ones(rows, 1)
    mask[rows // 2] = 0.0                 # a masked slot: the uniform softmax
    ins = [x.to(dev, dtype) for x in (q, v, mem, proj)]
    _attention_close(_attention_launch(ins, mask.to(dev)), ins,
                     mask.to(dev))


def test_prefetch_side_stream_matches_a_blocking_copy(dev):
    from cst_captioning_tpu_torch.data.prefetch import (
        place_blocking,
        prefetch_to_device,
    )

    g = np.random.default_rng(0)
    items = [({"a": g.normal(size=(64, 28, 512)).astype(np.float32)},
              g.integers(0, 9000, size=(64, 30)), ["v"] * 3)
             for _ in range(12)]
    for out, item in zip(prefetch_to_device(iter(items), size=3, device=dev),
                         items):
        # work queued on the consumer's stream first, as a step would
        torch.matmul(out[0]["a"][0], out[0]["a"][0].T)
        want = place_blocking(item, dev)
        assert torch.equal(out[0]["a"], want[0]["a"])
        assert torch.equal(out[1], want[1]) and out[2] == item[2]


def test_trainer_epoch_with_the_kernels(dev, tmp_path):
    """One XE and one pipelined CST epoch of the Trainer with
    attention_impl and decode_impl "pallas": kernels 1 and 2 launched,
    finite losses and a validation score."""
    import json

    from cst_captioning_tpu_torch import ops
    from cst_captioning_tpu_torch.data import (
        CaptionDataset,
        make_synthetic_dataset,
    )
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.train.trainer import Trainer

    mods = {"resnet": 40, "c3d": 24}
    paths = make_synthetic_dataset(str(tmp_path / "data"), num_videos=40,
                                   modalities=mods, max_frames=6, seed=2,
                                   caption_style="template")
    V = len(json.load(open(paths["info_json"]))["vocab"])
    cfg = get_experiment("msrvtt_cst_consensus").override(
        model__vocab_size=V, model__modalities=tuple(mods.items()),
        model__d_embed=32, model__d_hidden=32, model__d_att=16,
        model__max_len=10, model__max_frames=6,
        model__attention_impl="pallas", model__decode_impl="pallas",
        data__batch_size=8, train__epochs=1, rl__epochs=1,
        rl__num_rollouts=3, train__ckpt_dir=str(tmp_path / "ck"),
        train__log_every_steps=1)
    files = {n: paths[n] for n in mods}
    ds = {s: CaptionDataset(paths["info_json"], files, s, 6)
          for s in ("train", "val")}
    log = tmp_path / "log.jsonl"
    tr = Trainer(cfg, ds["train"], ds["val"], log_path=str(log), device=dev)
    ops.reset_launches()
    tr.train_xe()
    assert fused_additive_attention.launches == \
        cfg.model.max_len * tr.steps_per_epoch
    val = tr.train_rl()
    assert fused_decode_step.launches > 0 and val is not None
    events = [json.loads(line) for line in open(log)]
    for e in events:
        if e["event"] in ("xe_step", "rl_step"):
            assert np.isfinite(e.get("loss", e.get("rl_loss")))


def _serving_model(dev, seed):
    torch.manual_seed(seed)
    cfg = tcfg.ModelConfig(vocab_size=V, modalities=(("resnet", 20),),
                           d_embed=E, d_hidden=E, d_att=A,
                           encoder="temporal_attention", max_frames=F,
                           max_len=10, dtype="float32", decode_impl="pallas",
                           decode_stride=S)
    model = CaptionModel(cfg, device=dev)
    with torch.no_grad():
        model.cell.out_proj.bias[EOS_ID] += 2.0
    return model


def _serving_requests(n, seed0):
    from cst_captioning_tpu_torch.serving import ClipRequest

    g = np.random.default_rng(seed0)
    out = []
    for i in range(n):
        f = int(g.integers(1, F + 1))
        out.append(ClipRequest(
            f"q{seed0}_{i}",
            {"resnet": g.normal(size=(f, 20)).astype(np.float32)},
            {"resnet": np.ones((f,), np.float32)}, seed=seed0 + i))
    return out


def _alone(model, req, capacity):
    from cst_captioning_tpu_torch.serving import CaptionService

    svc = CaptionService(model, capacity=capacity, num_rollouts=K,
                         frame_bucket=2, device="cuda")
    return svc.serve([req]).results[req.req_id]


def test_serving_mixed_version_stride_on_the_card(dev):
    """A hot swap mid-flight on the card: one paged launch per live version
    a stride, the other version's lanes frozen and restored, and every
    request bit-equal to itself served alone under its pinned version."""
    from cst_captioning_tpu_torch.serving import CaptionService

    models = [_serving_model(dev, 0), _serving_model(dev, 1)]
    svc = CaptionService(models[0], capacity=3, num_rollouts=K,
                         frame_bucket=2, device="cuda")

    def feedback(req, result, version):
        svc.publish_params(models[1], version=1)

    svc._feedback = feedback
    pairs = []
    run_stride = svc._run_stride

    def counted(report, now):
        pairs.append(len({t.param_version for t in svc._inflight.values()}))
        run_stride(report, now)

    svc._run_stride = counted
    decode_stride.reset_launches()
    reqs = _serving_requests(8, 70)
    rep = svc.serve(reqs)
    assert fused_decode_stride_paged.launches == sum(pairs)
    assert max(pairs) == 2 and svc._old_versions == {}
    assert {r.param_version for r in rep.results.values()} == {0, 1}
    for req in reqs:
        res = rep.results[req.req_id]
        want = _alone(models[res.param_version], req, 3)
        np.testing.assert_array_equal(res.tokens, want.tokens)
        np.testing.assert_array_equal(res.logprobs, want.logprobs)


def test_serving_grown_lanes_on_the_card(dev):
    """grow_capacity with lane state on the card: requests served on the
    grown lanes are bit-equal to themselves served alone at that width."""
    from cst_captioning_tpu_torch.serving import CaptionService

    model = _serving_model(dev, 2)
    svc = CaptionService(model, capacity=2, num_rollouts=K, frame_bucket=2,
                         device="cuda")
    svc.serve(_serving_requests(3, 80))
    svc.grow_capacity(5)
    assert svc._lanes.token.shape == (1 + K, 5)
    reqs = _serving_requests(7, 90)
    rep = svc.serve(reqs)
    assert rep.completed == 7 and svc.bank.pages_in_use == 0
    for req in reqs:
        want = _alone(model, req, 5)
        np.testing.assert_array_equal(rep.results[req.req_id].tokens,
                                      want.tokens)
        np.testing.assert_array_equal(rep.results[req.req_id].logprobs,
                                      want.logprobs)


def _rl_pieces(dev, seed):
    """A small model with the attention and decode-step kernels on, a
    consensus reward over the clips and requests these tests name, and a
    state factory, for the decoupled and online learners."""
    from cst_captioning_tpu_torch import train as ttrain
    from cst_captioning_tpu_torch.data import Vocab
    from cst_captioning_tpu_torch.rl import RewardComputer

    torch.manual_seed(seed)
    cfg = tcfg.ModelConfig(vocab_size=V, modalities=(("resnet", 20),),
                           d_embed=E, d_hidden=E, d_att=A,
                           encoder="temporal_attention", max_frames=F,
                           max_len=10, dtype="float32",
                           attention_impl="pallas", decode_impl="pallas",
                           decode_stride=S)
    model = CaptionModel(cfg, device=dev)
    with torch.no_grad():
        model.cell.out_proj.bias[EOS_ID] += 2.0
    words = [f"w{i}" for i in range(V - 4)]
    g = np.random.default_rng(seed)
    ids = [f"q{i}" for i in range(B)] + [f"q100_{i}" for i in range(8)]
    gts = {v: [" ".join(g.choice(words[:20], 4)) for _ in range(3)]
           for v in ids}
    reward = RewardComputer(Vocab.from_corpus_words(words), gts)

    def state_of(m):
        tx = ttrain.make_optimizer(tcfg.TrainConfig(lr_decay_every=0), 10,
                                   lr_override=1e-3)
        return ttrain.create_train_state(m, tx)

    return model, reward, state_of


def test_decoupled_strict_equals_sync_on_the_card(dev):
    """AsyncSCSTTrainer(strict=True) on the card, pipelined and
    sequential, self-consensus baseline: the losses and params equal the
    sync SCSTTrainer's bitwise, with one decode-step launch per decode
    step."""
    import copy

    from cst_captioning_tpu_torch import ops
    from cst_captioning_tpu_torch import rl as trl

    model, reward, state_of = _rl_pieces(dev, 5)
    g = np.random.default_rng(6)
    batches = [({"resnet": torch.from_numpy(
        g.normal(size=(B, F, 20)).astype(np.float32)).to(dev)},
        {"resnet": torch.ones((B, F), device=dev)},
        [f"q{i}" for i in range(B)], None) for _ in range(4)]
    seeds = lambda j: 40 + j  # noqa: E731
    for pipelined in (True, False):
        rl = tcfg.RLConfig(num_rollouts=3, baseline="scb",
                           pipelined=pipelined)
        s_state = state_of(copy.deepcopy(model))
        s_state, sm = trl.SCSTTrainer(s_state.model, reward, rl).train_epoch(
            s_state, batches, seeds, pipelined=pipelined)
        a_state = state_of(copy.deepcopy(model))
        a = trl.AsyncSCSTTrainer(a_state.model, reward, rl, strict=True)
        ops.reset_launches()
        a_state, am = a.train_epoch(a_state, batches, seeds)
        if dev.type == "cuda":
            assert fused_decode_step.launches == sum(m["decode_steps"]
                                                     for m in am)
        assert [m["rl_loss"] for m in am] == [m["rl_loss"] for m in sm]
        for x, y in zip(s_state.model.parameters(),
                        a_state.model.parameters()):
            assert torch.equal(x, y)


def test_online_loop_on_the_card(dev):
    """The online learner attached to a service on the card: updates,
    version-stamped publishes applied at stride boundaries."""
    import copy

    from cst_captioning_tpu_torch import rl as trl
    from cst_captioning_tpu_torch.serving import CaptionService

    served, reward, state_of = _rl_pieces(dev, 7)
    learner = state_of(copy.deepcopy(served))
    rl = tcfg.RLConfig(num_rollouts=K, baseline="greedy", rollout_depth=2,
                       staleness_bound=4, online_batch_size=2, swap_every=1)
    trainer = trl.OnlineSCSTTrainer(learner.model, reward, rl, learner)
    svc = CaptionService(served, capacity=3, num_rollouts=K, frame_bucket=2,
                         device=dev)
    trainer.attach(svc)
    rep = svc.serve(_serving_requests(8, 100))
    trainer.flush()
    assert rep.completed == 8
    assert trainer.last_applied + trainer.last_dropped == 4
    assert trainer.version == trainer.last_applied >= 2
    # the publish after the flush waits for the service's next stride
    assert 1 <= svc.param_version <= trainer.version
    assert all(np.isfinite(m["rl_loss"]) for m in trainer.history)


# ---- bfloat16 parameters ---------------------------------------------------------


def _bf16_pair(dev, dtype, seed=11):
    """(a bf16-param model, a float32-param model holding the same values)
    at the serving widths, kernels on, computing in ``dtype``."""
    kw = dict(vocab_size=V, modalities=(("resnet", 20),), d_embed=E,
              d_hidden=E, d_att=A, encoder="temporal_attention",
              max_frames=F, max_len=10, dtype=dtype, decode_impl="pallas",
              attention_impl="pallas", decode_stride=S)
    torch.manual_seed(seed)
    f32 = CaptionModel(tcfg.ModelConfig(**kw), device=dev)
    with torch.no_grad():
        f32.cell.out_proj.bias[EOS_ID] += 2.0
    b16 = CaptionModel(tcfg.ModelConfig(**kw, param_dtype="bfloat16"),
                       device=dev)
    b16.load_state_dict({k: v.bfloat16() for k, v in
                         f32.state_dict().items()})
    f32.load_state_dict(b16.state_dict())
    return b16.eval(), f32.eval()


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_params_equal_float32_holding_the_same_values(dev, dtype):
    """Kernels 1-5 read float32-packed weights, so a bf16-param model and
    a float32 one holding the same values give bitwise equal teacher
    forcing (kernel 1), sampling (kernel 2), the fused decode (kernel 3),
    beam search (kernel 5) and a serve (kernel 4)."""
    from cst_captioning_tpu_torch import ops
    from cst_captioning_tpu_torch.decoding import (
        beam_search,
        fused_decode,
        sample_decode,
    )
    from cst_captioning_tpu_torch.serving import CaptionService

    b16, f32 = _bf16_pair(dev, dtype)
    g = torch.Generator().manual_seed(3)
    feats = {"resnet": torch.randn(B, F, 20, generator=g).to(dev)}
    masks = {"resnet": torch.ones(B, F, device=dev)}
    labels = torch.randint(3, V, (B, 10), generator=g).to(dev)
    ops.reset_launches()
    with torch.no_grad():
        for run in (lambda m: m(feats, masks, labels),
                    lambda m: sample_decode(m, feats, masks, seed=1,
                                            num_rollouts=3),
                    lambda m: fused_decode(m, feats, masks, seed=2,
                                           num_rollouts=1),
                    lambda m: beam_search(m, feats, masks, beam_size=5)):
            assert _same(run(b16), run(f32))
    reps = [CaptionService(m, capacity=3, num_rollouts=K, frame_bucket=2,
                           device=dev).serve(_serving_requests(6, 300))
            for m in (b16, f32)]
    for rid, res in reps[0].results.items():
        assert np.array_equal(res.tokens, reps[1].results[rid].tokens)
        assert np.array_equal(res.logprobs, reps[1].results[rid].logprobs)
    assert fused_additive_attention.launches > 0
    assert fused_decode_step.launches > 0 and fused_beam_step.launches > 0
    assert fused_decode_stride.launches > 0
    assert fused_decode_stride_paged.launches > 0


def _bf16_step_close(ref, other):
    """chip_smoke's ``bf16p_step_close``: the loss within 2^-10 and the grad
    norm within 2^-8 relative; each Adam moment (mu = 0.1 g and nu = 0.001
    g^2 after one step) with each leaf's element errors within 2^-4 (mu)
    and 2^-3 (nu) of its largest value, each leaf's relative L2 distance
    within 2^-4 and 2^-3, the whole tree's within 2^-6 and 2^-5."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    ok = rel(other["loss"], ref["loss"]) <= 2.0 ** -10 and \
        rel(other["grad_norm"], ref["grad_norm"]) <= 2.0 ** -8
    for which, m in enumerate(("mu", "nu")):
        d2 = w2 = 0.0
        for w, g in zip(ref[m], other[m]):
            d = (g - w).abs().double()
            top = max(float(w.abs().max()), 1e-30)
            ok = ok and float(d.max()) <= 2.0 ** (which - 4) * top
            ok = ok and float(d.norm()) <= 2.0 ** (which - 4) * float(
                w.double().norm())
            d2 += float((d * d).sum())
            w2 += float((w.double() ** 2).sum())
        ok = ok and d2 ** 0.5 <= 2.0 ** (which - 6) * w2 ** 0.5
    return ok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_xe_step_on_the_card_against_the_cpu(dev, dtype):
    """One XE step of a bf16-param model (dropout 0) on the card and on
    the CPU from the same params: params and moments stay bfloat16, and
    the step is held by what it computed (``_bf16_step_close``: loss,
    grad norm and the Adam moments, which carry the gradient; Adam's
    first update is about lr an element whatever the gradient). The same
    gate refuses the card's step on half of the rows and the card's
    moments scaled by 1.05."""
    from cst_captioning_tpu_torch import train as ttrain

    b16, _ = _bf16_pair(dev, dtype)
    sd = {k: v.cpu() for k, v in b16.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    feats = {"resnet": torch.randn(B, F, 20, generator=g)}
    masks = {"resnet": torch.ones(B, F)}
    labels = torch.randint(3, V, (B, 10), generator=g)
    mask = torch.ones(B, 10)

    # dropout 0: the two devices' generators draw other masks
    cfg = dataclasses.replace(b16.cfg, dropout=0.0)

    def step(d, rows):
        m = CaptionModel(cfg, device=d)
        m.load_state_dict(sd)
        state = ttrain.create_train_state(m, ttrain.make_optimizer(
            tcfg.TrainConfig(lr=1e-3, grad_clip=5.0), 10))
        state, met = ttrain.make_xe_step(m, guard=True)(
            state, {k: x[:rows].to(d) for k, x in feats.items()},
            {k: x[:rows].to(d) for k, x in masks.items()},
            labels[:rows].to(d), mask[:rows].to(d),
            torch.ones(rows, device=d))
        assert met["nonfinite"] == 0.0
        assert {t.dtype for t in state.params + state.opt_state["mu"]
                + state.opt_state["nu"]} == {torch.bfloat16}
        f32 = lambda ts: [t.detach().float().cpu() for t in ts]  # noqa
        return dict(loss=met["loss"], grad_norm=met["grad_norm"],
                    mu=f32(state.opt_state["mu"]),
                    nu=f32(state.opt_state["nu"]))

    card, cpu = step(dev, B), step(torch.device("cpu"), B)
    assert _bf16_step_close(cpu, card)
    assert not _bf16_step_close(cpu, step(dev, B // 2))
    assert not _bf16_step_close(cpu, dict(
        card, mu=[t * 1.05 for t in card["mu"]],
        nu=[t * 1.05 for t in card["nu"]]))


def test_bf16_trainer_epochs_and_checkpoint_on_the_card(dev, tmp_path):
    """An XE and a CST epoch of the Trainer at param_dtype bfloat16 with
    the kernels on: finite losses, params and moments bfloat16, and the
    epoch-end checkpoint restoring them bit for bit."""
    import json

    from cst_captioning_tpu_torch.ckpt.checkpoint import load_state
    from cst_captioning_tpu_torch.data import (
        CaptionDataset,
        make_synthetic_dataset,
    )
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.train.trainer import Trainer

    mods = {"resnet": 40}
    paths = make_synthetic_dataset(str(tmp_path / "data"), num_videos=24,
                                   modalities=mods, max_frames=6, seed=3,
                                   caption_style="template")
    vocab = len(json.load(open(paths["info_json"]))["vocab"])
    cfg = get_experiment("msrvtt_cst_consensus").override(
        model__vocab_size=vocab, model__modalities=tuple(mods.items()),
        model__d_embed=32, model__d_hidden=32, model__d_att=16,
        model__max_len=10, model__max_frames=6, model__param_dtype="bfloat16",
        model__attention_impl="pallas", model__decode_impl="pallas",
        data__batch_size=8, train__epochs=1, rl__epochs=1,
        rl__num_rollouts=3, train__ckpt_dir=str(tmp_path / "ck"))
    ds = {s: CaptionDataset(paths["info_json"], {"resnet": paths["resnet"]},
                            s, 6) for s in ("train", "val")}
    tr = Trainer(cfg, ds["train"], ds["val"], device=dev)
    tr.train_xe()
    tr.train_rl()
    st = tr.state
    assert {t.dtype for t in st.params + st.opt_state["mu"]
            + st.opt_state["nu"]} == {torch.bfloat16}
    fresh = Trainer(cfg, ds["train"], ds["val"], device=dev).state
    back, _ = load_state(str(tmp_path / "ck"), "latest", fresh)
    for a, b in zip(st.params + st.opt_state["nu"],
                    back.params + back.opt_state["nu"]):
        assert _same(a, b)
