"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU, at small odd shapes (V and the widths not multiples of the block
sizes, one and two LSTM layers, float32 and bfloat16 banks, a fully masked
row): the stride kernel (dense and paged), the additive-attention kernel
with its gradient, the decode-step kernel (also at one lane, greedy's
shape) and the beam-step kernel (finished lanes, EOS blocked while
t < min_len), and the wrappers' refusals.
Marked ``gpu``: these skip without a CUDA device and run on the H100
(which has no jax, hence no conftest) with

    python -m pytest --noconftest tests/test_torch_cuda.py

(chip_smoke.py holds the same kernels at the full training and serving
shapes)."""

import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.config import EOS_ID
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import decode_stride
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_topk_plain,
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


def _paged(bank, seed=0):
    mem, proj, mask = bank
    width = -(-F // P)
    n = B * width
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed)) + 1
    pools = []
    for x in bank:
        xp = torch.nn.functional.pad(
            x, (0, 0, 0, width * P - F) if x.ndim == 3 else (0, width * P - F))
        pool = torch.zeros((n + 1, P) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        pool[order.to(x.device)] = xp.reshape((n, P) + tuple(x.shape[2:]))
        pools.append(pool)
    return (*pools, order.reshape(B, width).int().to(mem.device))


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
    # logits through a buffer the search allocates once
    model, carry, token, fin, bank, _, _ = _inputs(dev, 2, torch.bfloat16)
    carry = tuple((c.bfloat16(), h.bfloat16()) for c, h in carry)
    scores = torch.randn(G, B, generator=torch.Generator().manual_seed(2)
                         ).to(dev)
    w = stride_weights(model.cell)
    state = stack_carry(carry)
    buf = torch.empty((G, B, V), device=dev)
    ksc, kfl = fused_beam_step_(model.cell, state, token, fin, scores, *bank,
                                torch.bfloat16, t=2, min_len=1, weights=w,
                                logits=buf)
    pc, logits = decode_step_plain(w, carry, w.embt[token.long()], *bank)
    psc, pfl = beam_topk_plain(logits, fin, scores, t=2, min_len=1,
                               width=G + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(buf, logits, rtol=TOL, atol=TOL)
    _assert_beam_close(ksc, kfl, psc, pfl)
    for (a, b), (c, d) in zip(unstack_carry(state, torch.bfloat16), pc):
        torch.testing.assert_close(a.float(), c.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)
        torch.testing.assert_close(b.float(), d.float(), rtol=TOL + BF16_ULP,
                                   atol=TOL)


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
