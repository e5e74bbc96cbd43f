#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cst_captioning_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the kernels' build (nvcc, from the sources in the repo).
2. kernels: every CUDA kernel of the serving and training paths, called
   through its wrapper on tensors on the card at the shapes those paths
   give it, held against its plain PyTorch version on the same inputs:
   - the stride kernels (dense, paged) at the serving shapes (capacity 32,
     K=2, S=8, msrvtt width: V=9000, E=H=512, A=256, 56 memory slots),
     float32 and bfloat16 pools. Tokens must be equal except at argmax
     near-ties (the plain version's top-2 gap at the first divergence
     <= 1e-3); logprobs and the carry of rows still live within 1e-4;
   - the additive-attention kernel at the XE step's B=64 and the REINFORCE
     update's B=320 (M=56, the training model's own encoder output) and at
     M=1000 (ragged masks, one fully masked row), float32 within 1e-4 of
     the plain version; bfloat16 within 2^-8 of the value (its output's
     one rounding) plus 1e-3 of the row's largest value of the kernel's
     numerics in float32 (``additive_attention_f32``; the plain composite
     also rounds scores and weights to bfloat16, so its distance is only
     reported); its gradient equals the plain version's autograd;
   - the decode-step kernel at G=5, B=64 through the rollout's in-place
     wrapper, float32 bank and carry, and bfloat16 bank and carry (the
     rollout's): logits within 1e-4, the carry within 1e-4 plus one
     bfloat16 ulp (2^-7 of the value) where it is rounded to bfloat16.
   Times are CUDA-event medians of 2 x 20 calls after warm-up, taken in
   turns; the bound is computed from each call's shapes.
3. serve: CaptionService at msrvtt_xe_attention full width (seeded random
   weights, +2 on the EOS bias so caption lengths vary) answers 64 trace
   requests on the paged path and again on the dense-gather path; the
   launch counters, set to 0 just before, must show one kernel launch per
   stride on each; the two paths must agree exactly, and at least 95% of
   requests must agree on all lanes with the same requests served through
   the plain version on the card. Also reported: how many of the serve's
   counter-noise draws differ in any bit between the CPU and the card.
4. train: msrvtt_cst_consensus at full width with attention_impl and
   decode_impl "pallas" (seeded random weights with a unigram prior on the
   corpus words, see ``train_model``), on a seeded in-memory corpus of 64
   clips (4-28 frames, 5 template captions each): 3 XE steps (dropout 0.5,
   Adam, clip 5, guard on) with 30 attention launches per step, then 3 CST
   steps (K=5 rollouts, self-consensus baseline, CIDEr-D + 0.5 BLEU4) with
   a fresh optimizer at the RL rate: one decode-step launch per decode
   step and 30 attention launches per update. One XE step and one CST
   step are run again from the same state and seeds with the plain
   versions patched in: XE loss within 1e-3 relative; at least 95% of the
   (rollout, clip) token rows equal, with equal rewards where equal; the
   update on the same tokens within 1e-3 relative in rl_loss.
5. profile: device time by kernel over one more serve and one more CST
   step, from torch.profiler, and the device's idle share.
6. kernels: one JSON line with each kernel's TPU counterpart, launches on
   its path, error, times and bound.

Each phase prints one JSON line; the card's nvidia-smi line and the kernels
line come before the last line, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before it; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from cst_captioning_tpu_torch import ops
from cst_captioning_tpu_torch.config import EOS_ID, PAD_ID
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.data import Vocab, encode_label_row
from cst_captioning_tpu_torch.decoding import common as decoding_common
from cst_captioning_tpu_torch.decoding import counter_gumbel_noise
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import build
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
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
from cst_captioning_tpu_torch.presets import get_experiment, get_preset
from cst_captioning_tpu_torch.rl import RewardComputer, SCSTTrainer
from cst_captioning_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_xe_step,
    xe_row_weights,
)
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    TrafficSpec,
    make_trace,
    synth_request_features,
)
from cst_captioning_tpu_torch.serving import engine

CAPACITY, K, S, FRAME_BUCKET = 32, 2, 8, 4
N_REQUESTS = 64
TOL = 1e-4
BF16_ROUND = 2.0 ** -8   # one bfloat16 rounding, relative to the value
BF16_ULP = 2.0 ** -7     # one bfloat16 ulp, relative to the value
ROW_TOL = 1e-3           # of the row's largest value: sum order, tanh
TIE_GAP = 1e-3
REL_TOL = 1e-3           # kernel vs plain, end to end through a step
AGREE = 0.95             # share of token rows that must agree
TRAIN_B, XE_STEPS, CST_STEPS = 64, 3, 3
# H100 SXM data sheet: float32
# outside the tensor cores, and HBM3 bandwidth, at the 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
CSRC = "cst_captioning_tpu_torch/ops/csrc/"
KERNELS = ("fused_decode_stride", "fused_decode_stride_paged")
SOURCE = {
    "fused_additive_attention": CSRC + "additive_attention.cu",
    "fused_decode_step": CSRC + "decode_step.cu",
    "fused_decode_stride": CSRC + "decode_stride.cu",
    "fused_decode_stride_paged": CSRC + "decode_stride.cu",
}
REPLACES = {
    "fused_additive_attention": "cst_captioning_tpu/ops/attention_pallas.py:169",
    "fused_decode_step": "cst_captioning_tpu/ops/decode_pallas.py:358",
    "fused_decode_stride": "cst_captioning_tpu/ops/decode_pallas.py:839",
    "fused_decode_stride_paged": "cst_captioning_tpu/ops/decode_pallas.py:1214",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def model_config():
    return dataclasses.replace(get_preset("msrvtt_xe_attention"),
                               decode_impl="pallas", decode_stride=S)


def make_model(dev):
    cfg = model_config()
    model = CaptionModel(cfg, device=dev)
    return load_flax_params(model, random_flax_params(cfg, seed=0,
                                                      eos_bias=2.0)).eval()


# ---- phase 2: kernels against their plain versions ------------------------


def stride_inputs(model, dev, bf16: bool, seed: int = 1):
    """Serving-shaped stride inputs: B=32 rows of ragged clips encoded by the
    model, some rows finished, a compaction prefix of 28, pages of 8 slots
    scattered over a pool in random order."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    B, G, F = CAPACITY, 1 + K, cfg.max_frames
    frames = rng.integers(1, F + 1, size=B)
    feats = {n: torch.from_numpy(rng.normal(size=(B, F, d)).astype(np.float32)
                                 ).to(dev) for n, d in cfg.modalities}
    mask = torch.from_numpy(
        (np.arange(F)[None] < frames[:, None]).astype(np.float32)).to(dev)
    with torch.no_grad():
        enc = model.encode(feats, {n: mask for n, _ in cfg.modalities})
    bank_dtype = torch.bfloat16 if bf16 else torch.float32
    mem = enc.memory.to(bank_dtype)
    proj = enc.memory_proj.to(bank_dtype)
    M = mem.shape[1]
    lens = torch.from_numpy(rng.integers(1, M + 1, size=B).astype(np.int32))
    # f32 carry in both cases, so the carry is compared before rounding
    carry = tuple((c.float()[None].expand(G, -1, -1).contiguous(),
                   h.float()[None].expand(G, -1, -1).contiguous())
                  for c, h in enc.carry)
    token = torch.from_numpy(
        rng.integers(3, cfg.vocab_size, size=(G, B)).astype(np.int32)).to(dev)
    n_active = B - 4
    finished = torch.zeros((G, B), dtype=torch.bool)
    finished[:, n_active:] = True
    finished[:, 3::7] = True
    finished[2, 5] = True
    noise = counter_gumbel_noise(
        torch.arange(B, device=dev) + 100,
        torch.arange(S, device=dev)[:, None].expand(S, B), K, cfg.vocab_size)
    # pages: P = n_mod * bucket slots, width = M / P, random pool order
    P = len(cfg.modalities) * FRAME_BUCKET
    width = -(-M // P)
    n_pages = B * width
    order = torch.from_numpy(rng.permutation(n_pages) + 1)
    table = order.reshape(B, width).to(torch.int32)
    pad = width * P - M
    pools = []
    for x in (mem, proj, enc.memory_mask.float()):
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad) if x.ndim == 3
                                     else (0, pad))
        pool = torch.zeros((n_pages + 1, P) + tuple(x.shape[2:]),
                           dtype=x.dtype, device=dev)
        pool[order.to(dev)] = xp.reshape((n_pages, P) + tuple(x.shape[2:]))
        pools.append(pool)
    return dict(
        carry=carry, token=token, finished=finished.to(dev),
        dense=(mem, proj, enc.memory_mask.float()),
        paged=(*pools, table.to(dev)), noise=noise, t0=0, n_active=n_active,
        mem_lens=lens.to(dev),
    )


def run_kernel(name, model, x):
    fn = fused_decode_stride_paged if name.endswith("paged") else \
        fused_decode_stride
    bank = x["paged"] if name.endswith("paged") else x["dense"]
    return fn(model.cell, x["carry"], x["token"], x["finished"], *bank,
              x["noise"], x["t0"], x["n_active"], steps=S, temperature=1.0,
              min_len=0, mem_lens=x["mem_lens"])


def run_plain(name, model, x, return_gap=False):
    bank = x["dense"]
    if name.endswith("paged"):
        bank = gather_pages(*x["paged"])
    return decode_stride_plain(
        stride_weights(model.cell), x["carry"], x["token"], x["finished"],
        *bank, x["noise"], x["t0"], x["n_active"], steps=S, temperature=1.0,
        min_len=0, mem_lens=x["mem_lens"], return_gap=return_gap)


def compare(name, model, x) -> dict:
    (kc, ktok, klp) = run_kernel(name, model, x)
    (pc, ptok, plp, gap) = run_plain(name, model, x, return_gap=True)
    torch.cuda.synchronize()
    ktok, ptok = ktok.cpu(), ptok.cpu()
    klp, plp, gap = klp.cpu(), plp.cpu(), gap.cpu()
    diff = ktok != ptok                                   # [S, G, B]
    diverged = diff.any(dim=0)                            # [G, B]
    first = diff.int().argmax(dim=0)                      # [G, B]
    near_ties = 0
    for g, b in diverged.nonzero().tolist():
        s = int(first[g, b])
        check(float(gap[s, g, b]) <= TIE_GAP,
              f"{name}: lane {g} row {b} step {s} diverges with plain-version "
              f"top-2 gap {float(gap[s, g, b]):.3e} > {TIE_GAP}")
        near_ties += 1
    # logprobs up to each row's first divergence; carry of rows live at the
    # end that never diverged
    steps = torch.arange(S)[:, None, None]
    upto = ~diverged[None] | (steps < first[None])
    lp_err = float((klp - plp).abs()[upto].max())
    check(lp_err <= TOL, f"{name}: logprob error {lp_err:.3e} > {TOL}")
    fin_end = x["finished"].cpu() | (ktok == EOS_ID).any(dim=0)
    live = ~fin_end & ~diverged
    check(bool(live.any()), f"{name}: no live row to compare the carry on")
    c_err = 0.0
    for (kc_, kh), (pc_, ph) in zip(kc, pc):
        for a, b in ((kc_, pc_), (kh, ph)):
            a, b = a.float().cpu()[live], b.float().cpu()[live]
            err = (a - b).abs()
            check(bool((err <= TOL + TOL * b.abs()).all()),
                  f"{name}: carry error {float(err.max()):.3e}")
            c_err = max(c_err, float(err.max()))
    check(bool((ktok[:, x["finished"].cpu()] == PAD_ID).all()),
          f"{name}: a finished row emitted a token")
    return {"tokens_equal": int((~diverged).sum()),
            "rows": int(diverged.numel()), "near_ties": near_ties,
            "max_abs_err": max(lp_err, c_err)}


def event_times(fn, reps=20, warmup=3) -> list[float]:
    """CUDA-event times (ms) of ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def smi_query(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def bound_ms(name, model, x, tokens) -> tuple[float, str]:
    """Least time for this call: bytes each input read once and each output
    written once, or float32 operations of the (row, lane, step)s that this
    run's data steps, whichever is larger."""
    cfg = model.cfg
    w = stride_weights(model.cell)
    E, H, A, V = cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size
    L = cfg.num_layers
    lens = x["mem_lens"].clamp(min=1).cpu()
    live = tokens.cpu() != PAD_ID                         # [S, G, B] stepped
    n_steps = int(live.sum())
    slots = int(lens[None, None, :].expand_as(live)[live].sum())
    # q, LSTM gates, output projection: 2 ops per weight; attention per
    # slot: A adds, tanh, A multiply-adds, E multiply-adds for the context
    per_step = 2 * (H * A + (2 * E) * 4 * H + (L - 1) * H * 4 * H
                    + L * H * 4 * H + H * V) + 10 * L * H + 6 * V
    ops = n_steps * per_step + slots * (4 * A + 2 * E)
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, w.embt))
    # the bank slots of rows that step at least once
    rows = live.any(dim=0).any(dim=0)
    bank = x["dense"] if not name.endswith("paged") else gather_pages(
        *x["paged"])
    for t in bank:
        nbytes += int(lens[rows].sum()) * t[0, 0].numel() * t.element_size()
    nbytes += int(live[:, 1:].sum()) * V * 4          # noise of sampled steps
    nbytes += sum(2 * t.numel() * 4 for layer in x["carry"] for t in layer)
    G, B = tokens.shape[1:]
    nbytes += 2 * tokens.numel() * 4 + (2 * G * B + B) * 4
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def noise_mismatches(dev) -> tuple[int, int]:
    """Counter-noise draws at the serving shapes, made on the CPU and on
    the card: (draws, draws whose bits differ)."""
    g = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 2**31 - 1, (CAPACITY,), generator=g)
    ts = (torch.arange(S)[:, None]
          + torch.randint(0, 30, (CAPACITY,), generator=g)[None])
    cpu = counter_gumbel_noise(seeds, ts, K, model_config().vocab_size)
    gpu = counter_gumbel_noise(seeds.to(dev), ts.to(dev), K,
                               model_config().vocab_size).cpu()
    return cpu.numel(), int((cpu != gpu).sum())


# ---- phase 3: serving -------------------------------------------------------


def requests(cfg):
    trace = make_trace(TrafficSpec(num_requests=N_REQUESTS,
                                   frame_choices=(4, 12, 28)))
    out = []
    for item in trace.items:
        feats, masks = synth_request_features(item, cfg.modalities)
        # a burst: every request arrives at t=0, so latency is the time
        # from the start of serving to the request's completion
        out.append(ClipRequest(item.req_id, feats, masks, seed=item.seed))
    return out


def service(model, **kw):
    return CaptionService(model, capacity=CAPACITY, num_rollouts=K, stride=S,
                          frame_bucket=FRAME_BUCKET, device="cuda", **kw)


def plain_paged(cell, carry, token, finished, mem_pool, proj_pool, mask_pool,
                table, noise, t0, n_active, *, steps, temperature, min_len,
                num_layers, mem_lens):
    """The paged stride through the plain version, on the card."""
    del num_layers
    return decode_stride_plain(
        stride_weights(cell), carry, token, finished,
        *gather_pages(mem_pool, proj_pool, mask_pool, table), noise, t0,
        n_active, steps=steps, temperature=temperature, min_len=min_len,
        mem_lens=mem_lens)


def serve_timed(svc, reqs):
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = svc.serve(reqs)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t


def profile_serve(model, reqs) -> dict:
    """Device time by kernel over one serve, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    svc = service(model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return device_breakdown(prof, wall_ms)


def check_results(rep, cfg) -> None:
    check(rep.completed == N_REQUESTS, f"{rep.completed} of {N_REQUESTS} "
          "requests completed")
    for rid, res in rep.results.items():
        check(res.tokens.shape == (1 + K, cfg.max_len), f"{rid} tokens shape")
        check(bool(np.isfinite(res.logprobs).all()), f"{rid} logprobs finite")
        check(bool((res.logprobs <= 0).all()), f"{rid} logprobs <= 0")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
              f"{rid} token ids in range")
        check(0 <= res.best_lane <= K, f"{rid} best lane")


# ---- the training model, corpus and kernels --------------------------------


def train_config():
    """msrvtt_cst_consensus with the attention and decode-step kernels."""
    exp = get_experiment("msrvtt_cst_consensus")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, attention_impl="pallas", decode_impl="pallas"))


def train_corpus(cfg, dev, seed=0) -> dict:
    """64 clips of 4-28 random-feature frames, each with 5 template
    captions "<det> <subject> <verb> <det> <object> [in the <place>]" over
    the vocab's words; a clip keeps its subject, object and place and
    varies its determiners and three verbs, so its references agree."""
    mc = cfg.model
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(mc.vocab_size - 4)]
    vocab = Vocab.from_corpus_words(words)
    B, F = TRAIN_B, mc.max_frames
    frames = rng.integers(4, F + 1, size=B)
    feats = {n: torch.from_numpy(rng.normal(size=(B, F, d)).astype(np.float32)
                                 ).to(dev) for n, d in mc.modalities}
    mask = torch.from_numpy(
        (np.arange(F)[None] < frames[:, None]).astype(np.float32)).to(dev)
    dets, subjects, verbs = words[0:4], words[10:60], words[60:110]
    objects, places, (w_in, w_the) = words[110:160], words[160:200], words[200:202]
    gts, caption_ids = {}, []
    for b in range(B):
        subj, obj, place = (rng.choice(x) for x in (subjects, objects, places))
        vs = rng.choice(verbs, 3, replace=False)
        caps = []
        for j in range(5):
            toks = [rng.choice(dets), subj, rng.choice(vs), rng.choice(dets),
                    obj] + ([w_in, w_the, place] if j % 2 == 0 else [])
            caps.append(" ".join(toks))
        gts[f"clip{b:03d}"] = caps
        caption_ids.append([vocab.encode(c.split()) for c in caps])
    used = sorted({w for caps in gts.values() for c in caps for w in c.split()})
    return dict(feats=feats, masks={n: mask for n, _ in mc.modalities},
                vocab=vocab, gts=gts, vids=list(gts), caption_ids=caption_ids,
                words=used)


def train_model(cfg, corpus, dev):
    """Seeded random weights with a unigram prior in the output bias: +4
    on the corpus's words and +7.5 on EOS, so that rollouts use the
    corpus's words and end after about ten tokens, as a model past its
    first XE epochs would (no trained checkpoint is in the repo)."""
    tree = random_flax_params(cfg.model, seed=0, eos_bias=7.5)
    bias = tree["params"]["cell"]["out_proj"]["bias"]
    bias[np.asarray(corpus["vocab"].encode(corpus["words"]))] += np.float32(4.0)
    return load_flax_params(CaptionModel(cfg.model, device=dev), tree)


def xe_batch(cfg, corpus, step: int, dev):
    """The XE batch of ``step``: each clip's caption ``step % 5``, every
    row valid with consensus weight 1, weighted as ``cfg.train.loss``
    says."""
    rows = [encode_label_row(ids[step % len(ids)], cfg.model.max_len)
            for ids in corpus["caption_ids"]]
    labels = torch.from_numpy(np.stack([r[0] for r in rows])).long().to(dev)
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    ones = torch.ones(TRAIN_B, device=dev)
    return (corpus["feats"], corpus["masks"], labels, mask,
            xe_row_weights(cfg.train.loss, ones, ones))


def attention_inputs(model, corpus, dtype, rows: int):
    """The attention's inputs at a training shape: the XE step's (64 rows)
    or the REINFORCE update's (320 rows: the bank tiled over the 5
    rollouts), from the model's encoder and initial query."""
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
        att = model.cell.attention
        q = att.query_proj(enc.carry[-1][1])
        reps = rows // TRAIN_B
        tile = lambda x: x.repeat((reps,) + (1,) * (x.ndim - 1))  # noqa: E731
        return (tile(q).to(dtype), att.score.detach().to(dtype),
                tile(enc.memory).to(dtype), tile(enc.memory_proj).to(dtype),
                tile(enc.memory_mask).contiguous())


def long_attention_inputs(model, dtype, M=1000, seed=2):
    """A long bank: M slots, ragged masks, row 3 fully masked."""
    cfg = model.cfg
    dev = model.device
    g = torch.Generator().manual_seed(seed)
    B, A, E = TRAIN_B, cfg.d_att, cfg.d_embed
    q = torch.randn(B, A, generator=g)
    mem = torch.tanh(torch.randn(B, M, E, generator=g))
    proj = torch.randn(B, M, A, generator=g)
    lens = torch.randint(1, M + 1, (B, 1), generator=g)
    mask = (torch.arange(M)[None] < lens).float()
    mask[3] = 0.0
    return (q.to(dev, dtype), model.cell.attention.score.detach().to(dtype),
            mem.to(dev, dtype), proj.to(dev, dtype), mask.to(dev))


def compare_attention(x) -> dict:
    """float32: against the plain version within TOL. bfloat16: against the
    kernel's own numerics in float32 (``additive_attention_f32``), within
    the output's one rounding (2^-8 of the value) plus ROW_TOL of the row's
    largest value; the plain version, which also rounds the scores and the
    weights, is reported beside it."""
    out = fused_additive_attention(*x)
    plain = additive_attention_plain(*x)
    torch.cuda.synchronize()
    if out.dtype == torch.float32:
        ref = plain
        limit = TOL + TOL * ref.abs()
    else:
        ref = additive_attention_f32(*x)
        limit = BF16_ROUND * ref.abs() \
            + ROW_TOL * ref.abs().amax(dim=-1, keepdim=True)
    err = (out.float() - ref).abs()
    check(bool((err <= limit).all()),
          f"attention ({out.dtype}): error {float(err.max()):.3e} over its "
          f"limit by {float((err - limit).max()):.3e}")
    # the gradient through the autograd rule equals the plain version's
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                    ).to(out.device)
    a = [t.clone().requires_grad_() for t in x[:4]]
    b = [t.clone().requires_grad_() for t in x[:4]]
    ga = torch.autograd.grad((fused_additive_attention(*a, x[4]).float()
                              * g).sum(), a)
    gb = torch.autograd.grad((additive_attention_plain(*b, x[4]).float()
                              * g).sum(), b)
    g_err = max(float((p.float() - q.float()).abs().max())
                for p, q in zip(ga, gb))
    check(g_err <= TOL, f"attention gradient error {g_err:.3e}")
    return {"max_abs_err": float(err.max()),
            "max_err_over_row_max": float(
                (err / ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
                 ).max()),
            "plain_max_abs_err": float((out.float() - plain.float()).abs().max()),
            "grad_max_abs_err": g_err}


def attention_bound(x) -> tuple[float, str]:
    """Bytes: every input once and the [B, E] output; operations: per
    slot the A-wide add, tanh and multiply-add and the E-wide weighted
    sum, in float32."""
    q, v, mem, proj, mask = x
    B, M, E = mem.shape
    A = q.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x) \
        + B * E * mem.element_size()
    ops = B * M * (4 * A + 2 * E)
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_inputs(model, corpus, bf16: bool, seed=3) -> dict:
    """The decode step's inputs at the rollout's shapes: G=5 lanes of the
    64 clips' encoder output, a perturbed carry and random tokens. With
    ``bf16`` the bank is bfloat16 and the carry in the model's carry dtype
    (bfloat16 at this preset), as the rollout gives them; else both are
    float32. ``state`` is the carry stacked as the rollout keeps it."""
    G = train_config().rl.num_rollouts
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
    dev = model.device
    dt = torch.bfloat16 if bf16 else torch.float32
    carry_dt = enc.carry[0][0].dtype if bf16 else torch.float32
    carry = tuple(
        tuple((x.float()[None].expand(G, -1, -1)
               + 0.1 * torch.randn((G,) + tuple(x.shape), generator=g).to(dev)
               ).to(carry_dt).contiguous() for x in layer)
        for layer in enc.carry)
    token = torch.randint(3, model.cfg.vocab_size, (G, TRAIN_B),
                          generator=g).to(dev)
    return dict(carry=carry, state=stack_carry(carry), token=token,
                w=stride_weights(model.cell),
                bank=(enc.memory.to(dt), enc.memory_proj.to(dt),
                      enc.memory_mask))


def run_step_kernel(model, x, state=None):
    """The rollout's call: the step on the stacked carry, in place."""
    return fused_decode_step_(
        model.cell, x["state"] if state is None else state, x["token"],
        *x["bank"], x["carry"][0][0].dtype, weights=x["w"])


def run_step_plain(x):
    w = x["w"]
    return decode_step_plain(w, x["carry"], w.embt[x["token"].long()],
                             *x["bank"])


def compare_step(model, x) -> dict:
    """Logits within TOL; the carry within TOL, plus one bfloat16 ulp (2^-7
    of the value) where the carry is rounded to bfloat16: the kernel rounds
    float32 values that differ from the plain version's in the last bits."""
    dtype = x["carry"][0][0].dtype
    state = stack_carry(x["carry"])
    klog = run_step_kernel(model, x, state)
    kc = unstack_carry(state, dtype)
    pc, plog = run_step_plain(x)
    torch.cuda.synchronize()
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    err = 0.0
    for (a, b), rel in [((klog, plog), TOL)] + [
            (p, TOL + ulp) for kl, pl in zip(kc, pc) for p in zip(kl, pl)]:
        d = (a.float() - b.float()).abs()
        check(bool((d <= TOL + rel * b.float().abs()).all()),
              f"decode step: error {float(d.max()):.3e}")
        err = max(err, float(d.max()))
    return {"max_abs_err": err, "carry_dtype": str(dtype)[6:]}


def step_bound(model, x) -> tuple[float, str]:
    """Bytes: the float32 weights the step reads (not the embedding table:
    its rows are gathered outside), the gathered rows, the bank, the carry
    in and out and the logits; operations: 2 per weight per (lane, row)
    plus the attention over the row's slots, in float32."""
    cfg = model.cfg
    w = x["w"]
    G, B = x["token"].shape
    E, H, A, V, L = (cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size,
                     cfg.num_layers)
    mem, proj, mask = x["bank"]
    M, Em = mem.shape[1], mem.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, mem, proj, mask))
    nbytes += G * B * (E + 4 * L * H + V) * 4
    per_row = 2 * (H * A + (E + Em) * 4 * H + (L - 1) * H * 4 * H
                   + L * H * 4 * H + H * V) + M * (4 * A + 2 * Em) + 10 * L * H
    t_ops = G * B * per_row / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- phase 4: training -------------------------------------------------------


def plain_decode_step_(cell, state, token, memory, memory_proj, memory_mask,
                       carry_dtype, num_layers=None, emb=None, weights=None):
    """The in-place decode step through its plain version, on the card."""
    del num_layers
    w = weights if weights is not None else stride_weights(cell)
    emb = w.embt[token.long()] if emb is None else emb
    carry, logits = decode_step_plain(w, unstack_carry(state, carry_dtype),
                                      emb, memory, memory_proj, memory_mask)
    state.copy_(stack_carry(carry))
    return logits


def plain_kernels():
    """Patch the plain versions in for the training path's kernels."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        attention_ops, "fused_additive_attention", additive_attention_plain))
    stack.enter_context(mock.patch.object(
        decoding_common.decode_step_ops, "fused_decode_step_",
        plain_decode_step_))
    return stack


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def launches() -> dict:
    return {"fused_additive_attention": fused_additive_attention.launches,
            "fused_decode_step": fused_decode_step.launches}


def xe_phase(cfg, corpus, state) -> dict:
    """One XE step kernel vs plain from the same state and dropout seed,
    then XE_STEPS counted steps."""
    T = cfg.model.max_len
    dev = state.model.device
    step = make_xe_step(state.model, cfg.train.label_smoothing, guard=True)
    a, b = state.clone(), state.clone()
    _, km = step(a, *xe_batch(cfg, corpus, 0, dev))
    with plain_kernels():
        _, pm = step(b, *xe_batch(cfg, corpus, 0, dev))
    del a, b
    xe_rel = rel_err(km["loss"], pm["loss"])
    check(xe_rel <= REL_TOL, f"XE loss kernel {km['loss']} vs plain "
          f"{pm['loss']}: relative {xe_rel:.3e} > {REL_TOL}")
    ops.reset_launches()
    times, losses = [], []
    for i in range(XE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, *xe_batch(cfg, corpus, i, dev))
        times.append(time.perf_counter() - t)       # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["loss"]),
              f"XE step {i} not finite: {m}")
        losses.append(m["loss"])
    n = launches()
    check(n == {"fused_additive_attention": T * XE_STEPS,
                "fused_decode_step": 0},
          f"XE launches {n}, expected {T} attention launches per step")
    ms = float(np.median(times)) * 1e3
    return {"steps": XE_STEPS, "launches": n, "losses": losses,
            "step_ms": [t * 1e3 for t in times], "step_ms_median": ms,
            "clips_per_s": TRAIN_B / (ms / 1e3), "plain_loss": pm["loss"],
            "kernel_loss": km["loss"], "loss_rel_err": xe_rel}


def cst_vs_plain(trainer, state, corpus) -> dict:
    """Decode from the same params and seed with the kernels and with the
    plain versions; then the update on the kernel's tokens from the same
    state, both ways."""
    feats, masks, vids = corpus["feats"], corpus["masks"], corpus["vids"]
    ks = trainer.decode(state.model, feats, masks, 99)
    with plain_kernels():
        ps = trainer.decode(state.model, feats, masks, 99)
    ks_np, ps_np = ks.cpu().numpy(), ps.cpu().numpy()
    Kr, B, T = ks_np.shape
    equal = (ks_np == ps_np).all(axis=-1).reshape(-1)
    share = float(equal.mean())
    check(share >= AGREE, f"rollout rows equal {share:.3f} < {AGREE}")
    rk = trainer.reward(vids, ks_np.reshape(Kr * B, T))
    rp = trainer.reward(vids, ps_np.reshape(Kr * B, T))
    check(np.array_equal(rk[equal], rp[equal]),
          "equal rollouts scored different rewards")
    valid = np.ones((B,), np.float32)
    adv, _ = trainer._advantage(ks_np, vids, valid)
    a, b = state.clone(), state.clone()
    _, km = trainer._apply(a, adv, {}, ks, feats, masks, valid)
    with plain_kernels():
        _, pm = trainer._apply(b, adv, {}, ks, feats, masks, valid)
    del a, b
    rl_rel = rel_err(km["rl_loss"], pm["rl_loss"])
    check(rl_rel <= REL_TOL, f"rl_loss kernel {km['rl_loss']} vs plain "
          f"{pm['rl_loss']}: relative {rl_rel:.3e} > {REL_TOL}")
    return {"rows_equal": share, "rows": int(equal.size),
            "kernel_rl_loss": km["rl_loss"], "plain_rl_loss": pm["rl_loss"],
            "rl_loss_rel_err": rl_rel}


def cst_phase(cfg, corpus, trainer, state) -> dict:
    agreement = cst_vs_plain(trainer, state, corpus)
    T = cfg.model.max_len
    ops.reset_launches()
    steps = []
    for i in range(CST_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                      corpus["vids"], seed=100 + i)
        m["step_s"] = time.perf_counter() - t        # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"]),
              f"CST step {i} not finite: {m}")
        steps.append(m)
    n = launches()
    decode_steps = sum(m["decode_steps"] for m in steps)
    check(n == {"fused_additive_attention": T * CST_STEPS,
                "fused_decode_step": decode_steps},
          f"CST launches {n}: expected one decode-step launch per decode "
          f"step ({decode_steps}) and {T} attention launches per update")
    med = lambda key: float(np.median([m[key] for m in steps])) * 1e3  # noqa: E731
    return {"steps": CST_STEPS, "launches": n, "decode_steps": decode_steps,
            "step_ms_median": med("step_s"), "decode_ms": med("decode_s"),
            "reward_ms": med("reward_s"), "update_ms": med("update_s"),
            "rl_clips_per_s": TRAIN_B / (med("step_s") / 1e3),
            "reward_mean": [m["reward_mean"] for m in steps],
            "rl_loss": [m["rl_loss"] for m in steps],
            "grad_norm": [m["grad_norm"] for m in steps], **agreement}


def device_breakdown(prof, wall_ms: float) -> dict:
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    check(busy > 0, "the profiler saw no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "top": [{"kernel": k[:90], "ms": ms, "count": n}
                    for k, ms, n in rows[:12]]}


def profile_cst(trainer, state, corpus) -> dict:
    """Device time by kernel over one CST step, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    state = state.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                  corpus["vids"], seed=200)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    out = device_breakdown(prof, wall_ms)
    out.update(decode_ms=m["decode_s"] * 1e3, reward_ms=m["reward_s"] * 1e3,
               update_ms=m["update_s"] * 1e3)
    return out


def time_in_turns(pairs: dict) -> dict:
    """{name: (kernel_fn, plain_fn)} -> {name: (kernel ms, plain ms)}:
    CUDA-event medians, each taken in turns (A B B A) so clock ramps hit
    both alike."""
    samples = {n: ([], []) for n in pairs}
    order = list(pairs)
    for name in order + order[::-1]:
        kfn, pfn = pairs[name]
        samples[name][0].extend(event_times(kfn))
        samples[name][1].extend(event_times(pfn))
    return {n: (float(np.median(k)), float(np.median(p)))
            for n, (k, p) in samples.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_query("name,power.limit")
    name = torch.cuda.get_device_name(0)
    t = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t
    ptxas = [ln.strip() for log in build.build_logs.values()
             for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    # ---- phase 2: every kernel against its plain version --------------------
    model = make_model(dev)
    cfg = model.cfg
    tcfg = train_config()
    corpus = train_corpus(tcfg, dev)
    tmodel = train_model(tcfg, corpus, dev)
    kernels = {k: {"max_abs_err": 0.0} for k in SOURCE}

    def record(kname, res):
        kernels[kname]["max_abs_err"] = max(kernels[kname]["max_abs_err"],
                                            res["max_abs_err"])

    timed = {}
    for kname in KERNELS:
        for bf16 in (False, True):
            x = stride_inputs(model, dev, bf16)
            res = compare(kname, model, x)
            emit({"phase": "kernel_check", "kernel": kname,
                  "bank_dtype": "bfloat16" if bf16 else "float32", **res})
            record(kname, res)
        timed[kname] = x    # the serving dtype: bfloat16 pools
    att = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, x in (
                ("xe_b64", attention_inputs(tmodel, corpus, dtype, TRAIN_B)),
                ("update_b320", attention_inputs(
                    tmodel, corpus, dtype, TRAIN_B * tcfg.rl.num_rollouts)),
                ("long_m1000", long_attention_inputs(tmodel, dtype))):
            res = compare_attention(x)
            emit({"phase": "kernel_check", "kernel": "fused_additive_attention",
                  "shape": label, "rows": x[0].shape[0],
                  "slots": x[2].shape[1], "dtype": str(dtype)[6:], **res})
            record("fused_additive_attention", res)
            att[label, dtype] = x
    for bf16 in (False, True):
        x = step_inputs(tmodel, corpus, bf16)
        res = compare_step(tmodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_decode_step",
              "lanes": x["token"].shape[0], "rows": x["token"].shape[1],
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_decode_step", res)
    step_x = x                          # the rollout's bank: bfloat16

    # the training shapes in the model dtype, bfloat16
    xe_att = att["xe_b64", torch.bfloat16]
    up_att = att["update_b320", torch.bfloat16]
    pairs = {k: (lambda k=k: run_kernel(k, model, timed[k]),
                 lambda k=k: run_plain(k, model, timed[k])) for k in KERNELS}
    pairs.update({
        "attention_b64": (lambda: fused_additive_attention(*xe_att),
                          lambda: additive_attention_plain(*xe_att)),
        "attention_b320": (lambda: fused_additive_attention(*up_att),
                           lambda: additive_attention_plain(*up_att)),
        "fused_decode_step": (lambda: run_step_kernel(tmodel, step_x),
                              lambda: run_step_plain(step_x)),
    })
    times = time_in_turns(pairs)
    clocks = smi_query("clocks.sm,power.draw")
    bounds = {k: bound_ms(k, model, timed[k], run_kernel(k, model,
                                                         timed[k])[1])
              for k in KERNELS}
    bounds.update(attention_b64=attention_bound(xe_att),
                  attention_b320=attention_bound(up_att),
                  fused_decode_step=step_bound(tmodel, step_x))
    for key, (ms, plain_ms) in times.items():
        bnd, by = bounds[key]
        emit({"phase": "kernel_time", "kernel": key, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
              "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    # the kernels line carries the update's shape for the attention kernel
    for k in KERNELS + ("fused_decode_step",):
        kernels[k].update(ms=times[k][0], plain_ms=times[k][1],
                          bound_ms=bounds[k][0], bound_by=bounds[k][1])
    kernels["fused_additive_attention"].update(
        ms=times["attention_b320"][0], plain_ms=times["attention_b320"][1],
        bound_ms=bounds["attention_b320"][0],
        bound_by=bounds["attention_b320"][1])
    del att, xe_att, up_att, step_x, pairs

    draws, mism = noise_mismatches(dev)
    emit({"phase": "noise", "draws": draws, "cpu_gpu_mismatches": mism})

    # ---- phase 3: serving ---------------------------------------------------
    reqs = requests(cfg)
    # warm-up: first-call costs (allocator, cuBLAS handles) stay out of
    # the timed serve
    service(model).serve(reqs[:4])
    svc = service(model)
    ops.reset_launches()
    rep, wall = serve_timed(svc, reqs)
    dense_rep, dense_wall = serve_timed(service(model, paged=False), reqs)
    serve_launches = {"fused_decode_stride_paged":
                      fused_decode_stride_paged.launches,
                      "fused_decode_stride": fused_decode_stride.launches}
    check_results(rep, cfg)
    check(serve_launches["fused_decode_stride_paged"] == rep.strides,
          f"paged launches {serve_launches} != strides {rep.strides}")
    check(serve_launches["fused_decode_stride"] == dense_rep.strides,
          f"dense launches {serve_launches} != strides {dense_rep.strides}")
    check(launches() == {"fused_additive_attention": 0,
                         "fused_decode_step": 0},
          f"the serve launched training kernels: {launches()}")
    for rid, res in rep.results.items():
        check(np.array_equal(res.tokens, dense_rep.results[rid].tokens)
              and np.array_equal(res.logprobs, dense_rep.results[rid].logprobs),
              f"{rid}: paged and dense-gather serving differ")
    with mock.patch.object(engine, "fused_decode_stride_paged", plain_paged):
        plain_rep, plain_wall = serve_timed(service(model), reqs)
    agree = np.mean([np.array_equal(res.tokens, plain_rep.results[r].tokens)
                     for r, res in rep.results.items()])
    check(agree >= AGREE, f"kernel/plain agreement {agree:.3f} < {AGREE}")
    lat = np.array([r.latency_s for r in rep.results.values()])
    gen = int(sum((r.tokens != PAD_ID).sum() for r in rep.results.values()))
    emit({"phase": "serve", "preset": "msrvtt_xe_attention",
          "capacity": CAPACITY, "K": K, "stride": S, "requests": N_REQUESTS,
          "strides": rep.strides, "launches": serve_launches,
          "plain_agreement": float(agree), "wall_s": wall,
          "requests_per_s": N_REQUESTS / wall, "tokens_per_s": gen / wall,
          "generated_tokens": gen, "p50_latency_s": float(np.percentile(lat, 50)),
          "p99_latency_s": float(np.percentile(lat, 99)),
          "dense_wall_s": dense_wall, "plain_wall_s": plain_wall,
          "sample_caption_ids": next(iter(rep.results.values())).caption_ids,
          "nvidia_smi": smi})

    # ---- phase 4: training --------------------------------------------------
    state = create_train_state(
        tmodel, make_optimizer(tcfg.train, steps_per_epoch=1),
        seed=tcfg.train.seed)
    xe = xe_phase(tcfg, corpus, state)
    emit({"phase": "train_xe", "preset": tcfg.name, "batch": TRAIN_B, **xe,
          "nvidia_smi": smi})
    rl = tcfg.rl
    reward = RewardComputer(
        corpus["vocab"], corpus["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    trainer = SCSTTrainer(tmodel, reward, rl, guard=True)
    # the RL phase starts a fresh optimizer at the RL rate
    rl_state = create_train_state(
        tmodel, make_optimizer(tcfg.train, 1, lr_override=rl.lr),
        seed=tcfg.train.seed)
    cst = cst_phase(tcfg, corpus, trainer, rl_state)
    emit({"phase": "train_cst", "preset": tcfg.name, "batch": TRAIN_B,
          "rollouts": rl.num_rollouts, "baseline": rl.baseline, **cst,
          "nvidia_smi": smi})
    path_launches = {**serve_launches, **{
        "fused_additive_attention": xe["launches"]["fused_additive_attention"]
        + cst["launches"]["fused_additive_attention"],
        "fused_decode_step": cst["launches"]["fused_decode_step"]}}

    # ---- phase 5: profiles --------------------------------------------------
    emit({"phase": "profile", "path": "serve",
          **profile_serve(model, reqs), "nvidia_smi": smi})
    emit({"phase": "profile", "path": "cst_step",
          **profile_cst(trainer, rl_state, corpus), "nvidia_smi": smi})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": REPLACES[k], "launches": path_launches[k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": v["bound_by"], "library_ms": None}
        for k, v in kernels.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
