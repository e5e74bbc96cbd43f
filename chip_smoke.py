#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cst_captioning_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the kernels' build (nvcc, from the sources in the repo).
2. kernels: every CUDA kernel of the serving, training and eval paths, called
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
     rollout's), and at G=1 (greedy decoding's shape): logits within 1e-4,
     the carry within 1e-4 plus one bfloat16 ulp (2^-7 of the value) where
     it is rounded to bfloat16;
   - the beam-step kernel at W=5, B=64 (the eval's) on the eval model,
     float32 and bfloat16 bank and carry, about 30% finished lanes, once
     with t < min_len: flat ids equal except where the plain version's
     totals tie within 1e-4 (counted), scores within 1e-4, the carry as
     the decode step's.
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
5. eval: Evaluator.evaluate (pipelined) at msrvtt_eval_beam5 with
   decode_impl "pallas" (beam 5, max_len 30, batch 64) over an in-memory
   split of 256 clips (4-28 frames, 20 template references each), the
   model fitted briefly first (``fitted_model``): one beam-step launch per
   beam step (counted at the search loop), at least 95% of clips with the
   caption the plain beam step gives on the card, all 8 metrics finite.
6. scst: msrvtt_scst (K=1, greedy baseline, CIDEr-D) with attention_impl
   and decode_impl "pallas" on the train corpus, from a model fitted
   briefly on it (``fitted_model``, as SCST starts from an XE model):
   3 steps, one dense
   stride-kernel launch per stride of the fused greedy-plus-rollout decode
   and 30 attention launches per update; against the plain versions: at
   least 95% of greedy and sampled rows equal, rl_loss on the same rows
   within one bfloat16 rounding (2^-8) of the loss's scale, the same sum
   over |advantage|: the greedy baseline's advantages take both signs and
   cancel in the loss, so an error relative to the loss itself says
   little (it is reported too), and the bfloat16 attention kernel and its
   plain version round at different places (the plain version rounds the
   scores and weights to bfloat16), which a fitted model's sharp logits
   carry into the logprobs.
7. profile: device time by kernel over one more serve, one more CST step
   and one beam-5 search of 64 clips, from torch.profiler, and the
   device's idle share.
8. kernels: one JSON line with each kernel's TPU counterpart, launches on
   its paths, error, times and bound.

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
import types
from unittest import mock

import numpy as np
import torch

from cst_captioning_tpu_torch import ops
from cst_captioning_tpu_torch.config import EOS_ID, PAD_ID
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.data import Vocab, encode_label_row
from cst_captioning_tpu_torch.decoding import beam as decoding_beam
from cst_captioning_tpu_torch.decoding import beam_search
from cst_captioning_tpu_torch.decoding import common as decoding_common
from cst_captioning_tpu_torch.decoding import counter_gumbel_noise
from cst_captioning_tpu_torch.decoding import fused as decoding_fused
from cst_captioning_tpu_torch.eval import Evaluator
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import beam_step as beam_ops
from cst_captioning_tpu_torch.ops import build
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_step_plain,
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
TRAIN_B, XE_STEPS, CST_STEPS, SCST_STEPS = 64, 3, 3, 3
BEAM_W = 5               # msrvtt_eval_beam5's beam
EVAL_CLIPS, EVAL_B, EVAL_REFS = 256, 64, 20
FIT_STEPS, FIT_LR = 100, 1e-2   # the eval model's short XE fit
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
    "fused_beam_step": CSRC + "beam_step.cu",
}
REPLACES = {
    "fused_additive_attention": "cst_captioning_tpu/ops/attention_pallas.py:169",
    "fused_decode_step": "cst_captioning_tpu/ops/decode_pallas.py:358",
    "fused_decode_stride": "cst_captioning_tpu/ops/decode_pallas.py:839",
    "fused_decode_stride_paged": "cst_captioning_tpu/ops/decode_pallas.py:1214",
    "fused_beam_step": "cst_captioning_tpu/ops/decode_pallas.py:1643",
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
                num_layers, mem_lens, weights=None):
    """The paged stride through the plain version, on the card."""
    del num_layers
    return decode_stride_plain(
        weights if weights is not None else stride_weights(cell), carry,
        token, finished,
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


def make_corpus(mc, n_clips: int, n_refs: int, seed: int) -> dict:
    """``n_clips`` clips of 4-28 random-feature frames (numpy), each with
    ``n_refs`` template captions "<det> <subject> <verb> <det> <object>
    [in the <place>]" over the vocab's words; a clip keeps its subject,
    object and place and varies its determiners and three verbs, so its
    references agree."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(mc.vocab_size - 4)]
    vocab = Vocab.from_corpus_words(words)
    F = mc.max_frames
    frames = rng.integers(4, F + 1, size=n_clips)
    feats = {n: rng.normal(size=(n_clips, F, d)).astype(np.float32)
             for n, d in mc.modalities}
    mask = (np.arange(F)[None] < frames[:, None]).astype(np.float32)
    dets, subjects, verbs = words[0:4], words[10:60], words[60:110]
    objects, places, (w_in, w_the) = words[110:160], words[160:200], words[200:202]
    gts, caption_ids = {}, []
    for b in range(n_clips):
        subj, obj, place = (rng.choice(x) for x in (subjects, objects, places))
        vs = rng.choice(verbs, 3, replace=False)
        caps = []
        for j in range(n_refs):
            toks = [rng.choice(dets), subj, rng.choice(vs), rng.choice(dets),
                    obj] + ([w_in, w_the, place] if j % 2 == 0 else [])
            caps.append(" ".join(toks))
        gts[f"clip{b:03d}"] = caps
        caption_ids.append([vocab.encode(c.split()) for c in caps])
    used = sorted({w for caps in gts.values() for c in caps for w in c.split()})
    return dict(feats=feats, mask=mask, vocab=vocab, gts=gts, vids=list(gts),
                caption_ids=caption_ids, words=used)


def on_device(c: dict, mc, dev) -> dict:
    """The corpus with its features and frame masks as tensors on ``dev``
    (``feats``, ``masks``: name -> [n, F, D] / [n, F])."""
    mask = torch.from_numpy(c["mask"]).to(dev)
    return {**c, "feats": {n: torch.from_numpy(x).to(dev)
                           for n, x in c["feats"].items()},
            "masks": {n: mask for n, _ in mc.modalities}}


def train_corpus(cfg, dev, seed=0) -> dict:
    """The train phase's 64 clips with 5 references each, on the card."""
    return on_device(make_corpus(cfg.model, TRAIN_B, 5, seed), cfg.model, dev)


def train_model(cfg, corpus, dev, eos_bias: float = 7.5):
    """Seeded random weights with a unigram prior in the output bias: +4
    on the corpus's words and +7.5 on EOS, so that rollouts use the
    corpus's words and end after about ten tokens, as a model past its
    first XE epochs would (no trained checkpoint is in the repo)."""
    tree = random_flax_params(cfg.model, seed=0, eos_bias=eos_bias)
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


def step_inputs(model, corpus, bf16: bool, seed=3, G=None) -> dict:
    """The decode step's inputs at the rollout's shapes: G=5 lanes (or
    ``G``: 1 is greedy decoding's) of the 64 clips' encoder output, a
    perturbed carry and random tokens. With ``bf16`` the bank is bfloat16
    and the carry in the model's carry dtype (bfloat16 at this preset), as
    the rollout gives them; else both are float32. ``state`` is the carry
    stacked as the rollout keeps it."""
    G = G or train_config().rl.num_rollouts
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


def beam_inputs(model, corpus, bf16: bool, t: int, min_len: int,
                seed=4) -> dict:
    """The beam step's inputs at the eval path's shapes: W=5 lanes of the
    64 clips' encoder output with a perturbed carry, random last tokens,
    about 30% finished lanes and running scores, at step ``t``. With
    ``bf16`` the bank and the carry are bfloat16, as beam eval gives them
    at this preset; else float32."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc = model.encode(corpus["feats"], corpus["masks"])
    dev = model.device
    dt = torch.bfloat16 if bf16 else torch.float32
    carry_dt = enc.carry[0][0].dtype if bf16 else torch.float32
    carry = tuple(
        tuple((x.float()[None].expand(BEAM_W, -1, -1)
               + 0.1 * torch.randn((BEAM_W,) + tuple(x.shape), generator=g
                                   ).to(dev)).to(carry_dt).contiguous()
              for x in layer)
        for layer in enc.carry)
    token = torch.randint(3, model.cfg.vocab_size, (BEAM_W, TRAIN_B),
                          generator=g).to(dev)
    finished = (torch.rand((BEAM_W, TRAIN_B), generator=g) < 0.3).to(dev)
    scores = (-3.0 * t * torch.rand((BEAM_W, TRAIN_B), generator=g)).to(dev)
    return dict(carry=carry, state=stack_carry(carry), token=token,
                finished=finished, scores=scores, t=t, min_len=min_len,
                w=stride_weights(model.cell),
                bank=(enc.memory.to(dt), enc.memory_proj.to(dt),
                      enc.memory_mask),
                logits=torch.empty((BEAM_W, TRAIN_B, model.cfg.vocab_size),
                                   device=dev))


def run_beam_kernel(model, x, state=None):
    """The search's call: the step on the stacked carry, in place."""
    return fused_beam_step_(
        model.cell, x["state"] if state is None else state, x["token"],
        x["finished"], x["scores"], *x["bank"], x["carry"][0][0].dtype,
        t=x["t"], min_len=x["min_len"], weights=x["w"], logits=x["logits"])


def run_beam_plain(x, width=None):
    w = x["w"]
    carry, logits = decode_step_plain(w, x["carry"], w.embt[x["token"].long()],
                                      *x["bank"])
    return (carry,) + beam_topk_plain(logits, x["finished"], x["scores"],
                                      t=x["t"], min_len=x["min_len"],
                                      width=width)


def compare_beam(model, x) -> dict:
    """Flat ids equal except where the plain version's totals tie within
    TOL at that position (its neighbours, the (W+1)-th included: counted
    as near-ties); scores within TOL; the carry as the decode step's."""
    dtype = x["carry"][0][0].dtype
    state = stack_carry(x["carry"])
    ksc, kfl = run_beam_kernel(model, x, state)
    kc = unstack_carry(state, dtype)
    pc, psc, pfl = run_beam_plain(x, width=BEAM_W + 1)
    torch.cuda.synchronize()
    ksc, kfl, psc, pfl = (v.cpu() for v in (ksc, kfl, psc, pfl))
    gap = psc[:, :-1] - psc[:, 1:]
    near = gap <= TOL
    near[:, 1:] |= gap[:, :BEAM_W - 1] <= TOL
    diff = kfl != pfl[:, :BEAM_W]
    check(not bool((diff & ~near).any()),
          f"beam step: flat ids differ away from a near-tie: "
          f"{int((diff & ~near).sum())} candidates")
    s_err = (ksc - psc[:, :BEAM_W]).abs()
    check(bool((s_err <= TOL + TOL * psc[:, :BEAM_W].abs()).all()),
          f"beam step: score error {float(s_err.max()):.3e}")
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    c_err = 0.0
    for kl, pl in zip(kc, pc):
        for a, b in zip(kl, pl):
            d = (a.float() - b.float()).abs()
            check(bool((d <= TOL + (TOL + ulp) * b.float().abs()).all()),
                  f"beam step: carry error {float(d.max()):.3e}")
            c_err = max(c_err, float(d.max()))
    V = model.cfg.vocab_size
    if x["t"] < x["min_len"]:
        check(not bool((kfl % V == EOS_ID).any()), "EOS chosen before min_len")
    fin = x["finished"].cpu()
    for g_, b in fin.nonzero().tolist():
        hit = (kfl[b] == g_ * V).nonzero()
        if len(hit):
            check(float(ksc[b, hit[0, 0]]) == float(x["scores"][g_, b]),
                  "a finished lane's PAD continuation moved its score")
    return {"max_abs_err": max(float(s_err.max()), c_err),
            "score_max_abs_err": float(s_err.max()),
            "near_tie_rows": int(diff.any(dim=1).sum()),
            "rows": int(diff.shape[0]), "finished_lanes": int(fin.sum()),
            "carry_dtype": str(dtype)[6:]}


def beam_bound(model, x) -> tuple[float, str]:
    """The decode step's bound without the logits' bytes (the TPU kernel
    keeps them on chip), plus the selection: bytes of the float32 weights,
    the bank, the gathered rows, the carry in and out, finished, scores
    and the [B, W] outputs; operations of the step and about 4 per logit
    (mask, max, exp, sum)."""
    cfg = model.cfg
    w = x["w"]
    W, B = x["token"].shape
    E, H, A, V, L = (cfg.d_embed, cfg.d_hidden, cfg.d_att, cfg.vocab_size,
                     cfg.num_layers)
    mem, proj, mask = x["bank"]
    M, Em = mem.shape[1], mem.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (
        w.wq, w.bq, w.v, w.wx, w.wh, w.bg, w.wo, w.bo, mem, proj, mask))
    nbytes += W * B * (E + 4 * L * H + 2) * 4 + 2 * B * W * 4
    per_row = 2 * (H * A + (E + Em) * 4 * H + (L - 1) * H * 4 * H
                   + L * H * 4 * H + H * V) + M * (4 * A + 2 * Em) \
        + 10 * L * H + 4 * V
    t_ops = W * B * per_row / PEAK_F32_FLOPS * 1e3
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


def plain_dense_stride(cell, carry, token, finished, memory, memory_proj,
                       memory_mask, noise, t0=0, n_active=None, *, steps,
                       temperature=1.0, min_len=0, num_layers=None,
                       mem_lens=None, weights=None):
    """The dense stride through its plain version, on the card."""
    del num_layers
    B, M = memory.shape[:2]
    if mem_lens is None:
        mem_lens = torch.full((B,), M, dtype=torch.int32)
    return decode_stride_plain(
        weights if weights is not None else stride_weights(cell), carry,
        token, finished, memory, memory_proj, memory_mask, noise, int(t0),
        B if n_active is None else int(n_active), steps=steps,
        temperature=temperature, min_len=min_len, mem_lens=mem_lens)


def plain_beam_step_(cell, state, token, finished, scores, memory,
                     memory_proj, memory_mask, carry_dtype, *, t, min_len=0,
                     num_layers=None, weights=None, logits=None):
    """The in-place beam step through its plain version, on the card."""
    del num_layers, logits
    w = weights if weights is not None else stride_weights(cell)
    carry, top_scores, top_flat = beam_step_plain(
        w, unstack_carry(state, carry_dtype), w.embt[token.long()], finished,
        scores, memory, memory_proj, memory_mask, t=t, min_len=min_len)
    state.copy_(stack_carry(carry))
    return top_scores, top_flat


def plain_kernels():
    """Patch the plain versions in for the training and eval paths'
    kernels: attention, the decode step, the offline dense stride and the
    beam step."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        attention_ops, "fused_additive_attention", additive_attention_plain))
    stack.enter_context(mock.patch.object(
        decoding_common.decode_step_ops, "fused_decode_step_",
        plain_decode_step_))
    stack.enter_context(mock.patch.object(
        decoding_fused, "fused_decode_stride", plain_dense_stride))
    stack.enter_context(mock.patch.object(
        beam_ops, "fused_beam_step_", plain_beam_step_))
    return stack


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def launches() -> dict:
    return {"fused_additive_attention": fused_additive_attention.launches,
            "fused_decode_step": fused_decode_step.launches}


def all_launches() -> dict:
    return {**launches(),
            "fused_decode_stride": fused_decode_stride.launches,
            "fused_decode_stride_paged": fused_decode_stride_paged.launches,
            "fused_beam_step": fused_beam_step.launches}


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
    _, ks = trainer.decode(state.model, feats, masks, 99)
    with plain_kernels():
        _, ps = trainer.decode(state.model, feats, masks, 99)
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
    adv, _ = trainer._advantage(None, ks_np, vids, valid)
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


# ---- phase 5: beam-5 eval ---------------------------------------------------


@dataclasses.dataclass
class Record:
    video_id: str
    caption_ids: list
    captions: list
    weights: list


class MemoryDataset:
    """``CaptionDataset``'s interface over a corpus held in memory: the
    split's records, feature stores (name -> ``.dim``), ``features_for``
    and the reference pools."""

    def __init__(self, corpus: dict, mc, split: str = "test"):
        self.vocab = corpus["vocab"]
        self.split = split
        self.max_frames = mc.max_frames
        self.stores = {n: types.SimpleNamespace(dim=d)
                       for n, d in mc.modalities}
        self._feats = corpus["feats"]
        self._mask = corpus["mask"]
        self._row = {v: i for i, v in enumerate(corpus["vids"])}
        self.records = [
            Record(v, ids, caps, [1.0] * len(caps)) for v, ids, caps in zip(
                corpus["vids"], corpus["caption_ids"],
                corpus["gts"].values())]

    def features_for(self, video_id: str) -> dict:
        i = self._row[video_id]
        return {n: (x[i], self._mask[i]) for n, x in self._feats.items()}

    def gts_pool(self) -> dict:
        return {r.video_id: list(r.captions) for r in self.records}


def fitted_model(cfg, corpus, dev):
    """A model past its first XE epochs: ``train_model``'s prior with +3
    on EOS, then FIT_STEPS XE steps (Adam at FIT_LR, the preset's dropout)
    over the corpus (on the card) in batches of 64, each clip's reference
    ``step % refs``. A model with the prior alone is the same at every
    step, so beam search ranks the empty caption first and greedy decoding
    emits EOS at once; the short fit makes EOS depend on the position, as
    in a trained model, so captions end before max_len with words in them.
    The fit sees the clips it is then scored on: the metrics measure the
    path, not the model. -> (model in eval mode, the fit's last loss)."""
    mc = cfg.model
    model = train_model(cfg, corpus, dev, eos_bias=3.0)
    state = create_train_state(
        model, make_optimizer(cfg.train, 1, lr_override=FIT_LR),
        seed=cfg.train.seed)
    step = make_xe_step(model, cfg.train.label_smoothing)
    n = len(corpus["vids"]) // EVAL_B
    ones = torch.ones(EVAL_B, device=dev)
    loss = float("nan")
    for i in range(FIT_STEPS):
        rows = slice((i % n) * EVAL_B, (i % n + 1) * EVAL_B)
        enc = [encode_label_row(ids[i % len(ids)], mc.max_len)
               for ids in corpus["caption_ids"][rows]]
        state, m = step(
            state, {k: x[rows] for k, x in corpus["feats"].items()},
            {k: x[rows] for k, x in corpus["masks"].items()},
            torch.from_numpy(np.stack([r[0] for r in enc])).long().to(dev),
            torch.from_numpy(np.stack([r[1] for r in enc])).to(dev), ones)
        loss = m["loss"]
    check(np.isfinite(loss), f"model fit: loss {loss}")
    return model.eval(), loss


def eval_config():
    """msrvtt_eval_beam5 with the beam-step kernel."""
    exp = get_experiment("msrvtt_eval_beam5")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, decode_impl="pallas"))


def counted_beam_steps():
    """Count the beam search's loop steps, apart from any kernel counter:
    wrap the early-exit loop's step function."""
    n = [0]
    real = decoding_beam.scan_until_finished

    def scan(step, init, length, get_finished, y_fills):
        def counted(state, t):
            n[0] += 1
            return step(state, t)
        return real(counted, init, length, get_finished, y_fills)

    return n, mock.patch.object(decoding_beam, "scan_until_finished", scan)


def eval_phase(cfg, data, model) -> dict:
    """Evaluator.evaluate (pipelined) over the split, the kernel launches
    against the beam steps, then the same batches through the plain beam
    step on the card."""
    ec = cfg.eval
    ev = Evaluator(model, data, ec, batch_size=EVAL_B)
    steps, counting = counted_beam_steps()
    torch.cuda.synchronize()
    ops.reset_launches()
    with counting:
        t = time.perf_counter()
        res = ev.evaluate()
        wall = time.perf_counter() - t
    n = all_launches()
    check(n["fused_beam_step"] == steps[0] > 0,
          f"eval: {n['fused_beam_step']} beam-step launches for {steps[0]} "
          "beam steps")
    check(all(v == 0 for k, v in n.items() if k != "fused_beam_step"),
          f"eval launched other kernels: {n}")
    caps = res["captions"]
    check(len(caps) == len(data.records), f"{len(caps)} captions for "
          f"{len(data.records)} clips")
    metrics = res["metrics"]
    keys = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "CIDEr-D",
            "METEOR_approx", "ROUGE_L"]
    check(sorted(metrics) == keys and all(np.isfinite(metrics[k])
                                          for k in keys),
          f"eval metrics {metrics}")
    with plain_kernels():
        t = time.perf_counter()
        plain = ev.generate()
        plain_wall = time.perf_counter() - t
    agree = float(np.mean([caps[v] == plain[v] for v in caps]))
    check(agree >= AGREE, f"eval: kernel/plain caption agreement {agree:.3f} "
          f"< {AGREE}")
    lens = [len(c.split()) for c in caps.values()]
    tm = ev.timing
    return {"clips": len(caps), "batch": EVAL_B, "beam": ec.beam_size,
            "beam_steps": steps[0], "launches": n,
            "decode_clips_per_s": len(caps) / tm["decode_s"],
            "decode_s": tm["decode_s"], "score_s": tm["score_s"],
            "eval_wall_s": wall, "drain_s": tm["drain_s"],
            "plain_agreement": agree, "plain_generate_s": plain_wall,
            "caption_words_mean": float(np.mean(lens)),
            "distinct_captions": len(set(caps.values())),
            "metrics": metrics, "sample_caption": next(iter(caps.values()))}


# ---- phase 6: greedy-baseline SCST ------------------------------------------


def scst_config():
    """msrvtt_scst with the attention, decode-step and stride kernels."""
    exp = get_experiment("msrvtt_scst")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, attention_impl="pallas", decode_impl="pallas"))


def scst_vs_plain(trainer, state, corpus) -> dict:
    """Greedy and sampled rows from the same params and seed with the
    kernels and with the plain versions; the update on the kernel's rows
    from the same state, both ways."""
    feats, masks, vids = corpus["feats"], corpus["masks"], corpus["vids"]
    kg, ks = trainer.decode(state.model, feats, masks, 99)
    with plain_kernels():
        pg, ps = trainer.decode(state.model, feats, masks, 99)
    rows_k = torch.cat([kg[None], ks]).cpu().numpy()
    rows_p = torch.cat([pg[None], ps]).cpu().numpy()
    equal = (rows_k == rows_p).all(axis=-1)                      # [1+K, B]
    share = float(equal.mean())
    check(share >= AGREE, f"scst rows equal {share:.3f} < {AGREE}")
    valid = np.ones((len(vids),), np.float32)
    adv, host = trainer._advantage(rows_k[0], rows_k[1:], vids, valid)
    a, b, c = state.clone(), state.clone(), state.clone()
    _, km = trainer._apply(a, adv, {}, ks, feats, masks, valid)
    with plain_kernels():
        _, pm = trainer._apply(b, adv, {}, ks, feats, masks, valid)
        # the loss's scale: its terms' magnitudes, |advantage| x -logprob,
        # summed as the loss is. The greedy baseline's advantages take
        # both signs and cancel in the loss, so its error is held to this
        _, am = trainer._apply(c, np.abs(adv), {}, ks, feats, masks, valid)
    del a, b, c
    err = abs(km["rl_loss"] - pm["rl_loss"])
    rl_scaled = err / max(am["rl_loss"], 1e-30)
    check(rl_scaled <= BF16_ROUND, f"scst rl_loss kernel {km['rl_loss']} vs "
          f"plain {pm['rl_loss']}: error {err:.3e} is {rl_scaled:.3e} of the "
          f"loss's scale {am['rl_loss']:.4f} > {BF16_ROUND}")
    return {"greedy_rows_equal": float(equal[0].mean()),
            "sampled_rows_equal": float(equal[1:].mean()),
            "kernel_rl_loss": km["rl_loss"], "plain_rl_loss": pm["rl_loss"],
            "rl_loss_scale": am["rl_loss"], "rl_loss_err_over_scale":
            rl_scaled, "rl_loss_rel_err": rel_err(km["rl_loss"],
                                                  pm["rl_loss"]),
            "greedy_reward_mean": host["baseline_mean"]}


def scst_phase(cfg, corpus, trainer, state) -> dict:
    agreement = scst_vs_plain(trainer, state, corpus)
    T, S = cfg.model.max_len, cfg.model.decode_stride
    ops.reset_launches()
    steps = []
    for i in range(SCST_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, corpus["feats"], corpus["masks"],
                                      corpus["vids"], seed=300 + i)
        m["step_s"] = time.perf_counter() - t        # the loss read syncs
        check(m["nonfinite"] == 0.0 and np.isfinite(m["rl_loss"]),
              f"SCST step {i} not finite: {m}")
        steps.append(m)
    n = all_launches()
    strides = sum(-(-m["decode_steps"] // S) for m in steps)
    check(n["fused_decode_stride"] == strides,
          f"SCST: {n['fused_decode_stride']} stride launches for {strides} "
          "strides")
    check(n["fused_additive_attention"] == T * SCST_STEPS,
          f"SCST: {n['fused_additive_attention']} attention launches, "
          f"expected {T} per update")
    check(n["fused_decode_step"] == n["fused_beam_step"] ==
          n["fused_decode_stride_paged"] == 0,
          f"SCST launched other kernels: {n}")
    med = lambda key: float(np.median([m[key] for m in steps])) * 1e3  # noqa: E731
    return {"steps": SCST_STEPS, "launches": n, "strides": strides,
            "decode_steps": [m["decode_steps"] for m in steps],
            "step_ms_median": med("step_s"), "decode_ms": med("decode_s"),
            "reward_ms": med("reward_s"), "update_ms": med("update_s"),
            "rl_clips_per_s": TRAIN_B / (med("step_s") / 1e3),
            "reward_mean": [m["reward_mean"] for m in steps],
            "baseline_mean": [m["baseline_mean"] for m in steps],
            "rl_loss": [m["rl_loss"] for m in steps], **agreement}


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


def profile_beam(model, corpus) -> dict:
    """Device time by kernel over one beam-5 search of 64 clips."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        beam_search(model, corpus["feats"], corpus["masks"],
                    beam_size=BEAM_W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return device_breakdown(prof, wall_ms)


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
    for bf16, G in ((False, None), (True, 1), (True, None)):
        x = step_inputs(tmodel, corpus, bf16, G=G)
        res = compare_step(tmodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_decode_step",
              "lanes": x["token"].shape[0], "rows": x["token"].shape[1],
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_decode_step", res)
    step_x = x                          # the rollout's bank: bfloat16
    # the beam step at the eval's shapes (W=5, B=64) on the eval model
    ecfg = eval_config()
    eval_corpus = make_corpus(ecfg.model, EVAL_CLIPS, EVAL_REFS, seed=5)
    t = time.perf_counter()
    emodel, fit_loss = fitted_model(
        ecfg, on_device(eval_corpus, ecfg.model, dev), dev)
    emit({"phase": "model_fit", "for": "eval", "steps": FIT_STEPS,
          "lr": FIT_LR, "last_loss": fit_loss, "s": time.perf_counter() - t})
    for bf16, t, min_len in ((False, 3, 0), (True, 3, 0), (True, 1, 3)):
        x = beam_inputs(emodel, corpus, bf16, t, min_len)
        res = compare_beam(emodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_beam_step",
              "lanes": BEAM_W, "t": t, "min_len": min_len,
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_beam_step", res)
    beam_x = beam_inputs(emodel, corpus, True, 3, 0)   # the eval's: bf16

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
        "fused_beam_step": (lambda: run_beam_kernel(emodel, beam_x),
                            lambda: run_beam_plain(beam_x)),
    })
    times = time_in_turns(pairs)
    clocks = smi_query("clocks.sm,power.draw")
    bounds = {k: bound_ms(k, model, timed[k], run_kernel(k, model,
                                                         timed[k])[1])
              for k in KERNELS}
    bounds.update(attention_b64=attention_bound(xe_att),
                  attention_b320=attention_bound(up_att),
                  fused_decode_step=step_bound(tmodel, step_x),
                  fused_beam_step=beam_bound(emodel, beam_x))
    for key, (ms, plain_ms) in times.items():
        bnd, by = bounds[key]
        emit({"phase": "kernel_time", "kernel": key, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
              "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    # the kernels line carries the update's shape for the attention kernel
    for k in KERNELS + ("fused_decode_step", "fused_beam_step"):
        kernels[k].update(ms=times[k][0], plain_ms=times[k][1],
                          bound_ms=bounds[k][0], bound_by=bounds[k][1])
    kernels["fused_additive_attention"].update(
        ms=times["attention_b320"][0], plain_ms=times["attention_b320"][1],
        bound_ms=bounds["attention_b320"][0],
        bound_by=bounds["attention_b320"][1])
    del att, xe_att, up_att, step_x, beam_x, pairs

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

    # ---- phase 5: beam-5 eval -----------------------------------------------
    ev = eval_phase(ecfg, MemoryDataset(eval_corpus, ecfg.model), emodel)
    emit({"phase": "eval", "preset": ecfg.name, "decode_impl": "pallas",
          **ev, "nvidia_smi": smi})

    # ---- phase 6: greedy-baseline SCST ---------------------------------------
    scfg = scst_config()
    srl = scfg.rl
    t = time.perf_counter()
    smodel, fit_loss = fitted_model(scfg, corpus, dev)
    emit({"phase": "model_fit", "for": "scst", "steps": FIT_STEPS,
          "lr": FIT_LR, "last_loss": fit_loss, "s": time.perf_counter() - t})
    s_reward = RewardComputer(
        corpus["vocab"], corpus["gts"], cider_weight=srl.reward_cider_weight,
        bleu_weight=srl.reward_bleu4_weight, bleu_scale=srl.reward_bleu4_scale,
        num_threads=srl.reward_threads)
    s_trainer = SCSTTrainer(smodel, s_reward, srl, guard=True)
    s_state = create_train_state(
        smodel, make_optimizer(scfg.train, 1, lr_override=srl.lr),
        seed=scfg.train.seed)
    sc = scst_phase(scfg, corpus, s_trainer, s_state)
    emit({"phase": "train_scst", "preset": scfg.name, "batch": TRAIN_B,
          "rollouts": srl.num_rollouts, "baseline": srl.baseline,
          "stride": scfg.model.decode_stride, **sc, "nvidia_smi": smi})

    # launches of each kernel on the paths it runs on, each path counted
    # from 0 just before it
    path_launches = {
        "fused_decode_stride_paged":
            serve_launches["fused_decode_stride_paged"],
        "fused_decode_stride": serve_launches["fused_decode_stride"]
        + sc["launches"]["fused_decode_stride"],
        "fused_additive_attention": xe["launches"]["fused_additive_attention"]
        + cst["launches"]["fused_additive_attention"]
        + sc["launches"]["fused_additive_attention"],
        "fused_decode_step": cst["launches"]["fused_decode_step"],
        "fused_beam_step": ev["launches"]["fused_beam_step"]}

    # ---- phase 7: profiles --------------------------------------------------
    emit({"phase": "profile", "path": "serve",
          **profile_serve(model, reqs), "nvidia_smi": smi})
    emit({"phase": "profile", "path": "cst_step",
          **profile_cst(trainer, rl_state, corpus), "nvidia_smi": smi})
    emit({"phase": "profile", "path": "beam5_batch",
          **profile_beam(emodel, corpus), "nvidia_smi": smi})

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
