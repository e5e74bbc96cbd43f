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
     float32 and bfloat16 pools, and the dense one at the SCST decode's
     (B=64, K=1, bfloat16 bank; timed too, and split by phase from the
     kernel's own timeline). Tokens must be equal except at argmax
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
   turns, with the weights packed once as the paths pack them (the
   decode step at G=1 too); the bound is computed from each call's
   shapes, and each time line gives the kernel's share of it (bound /
   time). The decode-step and beam-step kernels' device time a call is
   split by launch (q, attend, gates, cell, logits, merge) from
   torch.profiler over 10 more calls (``step_phases``). The attention
   kernel is timed at B=64, B=320 and M=1000 in bfloat16, in turns with
   its plain version, and by ``attention_phases``: its device time from
   torch.profiler over 10 calls (one launch a call), warm (the same
   inputs, which L2 holds) and cold (rotating through copies of the
   inputs that exceed twice the 50 MB L2), and the cold CUDA-event time;
   every call as the decoder makes it, on inputs that need gradients.
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
8. recipe: the trainer and the CLIs from files. A template corpus in the
   port's feature format (``data.synthetic``: msrvtt modalities, 28
   frames, 200 words, 384 / 64 / 128 clips, 5 captions a clip, about
   123 MB of features) with its WXE weights and CIDEr df
   (``data.preprocess``), in a temporary directory; then, in process:
   ``cli.train`` at msrvtt_cst_consensus with attention_impl and
   decode_impl "pallas", 2 XE epochs and 1 CST epoch (30 attention
   launches per XE step and per update, one decode-step launch per CST
   decode step, one per greedy validation step at G=1, best and latest
   written, every validation CIDEr-D finite); a 1-epoch XE run resumed
   ("auto") to 2 epochs, and a resume from a mid-epoch
   ``ckpt_every_steps`` save alone, each against the uninterrupted run
   (the same video ids at every step, the same infos, per-step losses
   within 1e-3 relative); msrvtt_scst for one RL epoch from the XE best
   (one dense stride launch per stride, 30 attention launches per
   update); ``cli.eval`` at msrvtt_eval_beam5 on the XE best with the
   beam-step kernel (one launch per beam step, 8 finite metrics); one
   XE epoch of msvd_xe_meanpool with kernel 1 (kernel 1 at M=1 against
   its plain version); the first batch of every epoch, staged by the
   prefetch thread on its side stream, equal to a blocking copy; the
   device idle share of a pipelined and a sequential CST epoch from
   torch.profiler. One ``recipe`` line: clips/s by epoch, validation
   ms, checkpoint save and restore ms and bytes, the idle shares, the
   eval wall and CIDEr-D after XE and after CST.
9. kernels: one JSON line with each kernel's TPU counterpart, launches on
   its paths (the recipe's included), error, times and bound; for the
   decode and beam steps also
   their device time by launch, and the decode step's at G=1; for the
   attention its warm and cold device and event times at B=320, and the
   same at B=64 and M=1000.

Each phase prints one JSON line; the card's nvidia-smi line and the kernels
line come before the last line, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before it; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch

from cst_captioning_tpu_torch import ops
from cst_captioning_tpu_torch.cli import eval as cli_eval
from cst_captioning_tpu_torch.cli import train as cli_train
from cst_captioning_tpu_torch.config import EOS_ID, PAD_ID
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.data import (
    Batcher,
    Vocab,
    compute_cider_df,
    compute_consensus_weights,
    encode_label_row,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.data import prefetch as prefetch_mod
from cst_captioning_tpu_torch.decoding import beam as decoding_beam
from cst_captioning_tpu_torch.decoding import beam_search
from cst_captioning_tpu_torch.decoding import common as decoding_common
from cst_captioning_tpu_torch.decoding import counter_gumbel_noise
from cst_captioning_tpu_torch.decoding import fused as decoding_fused
from cst_captioning_tpu_torch.decoding.common import decode_depth
from cst_captioning_tpu_torch.eval import Evaluator
from cst_captioning_tpu_torch.eval import evaluator as evaluator_mod
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import beam_step as beam_ops
from cst_captioning_tpu_torch.ops import build
from cst_captioning_tpu_torch.ops import decode_stride
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_step_plain,
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
from cst_captioning_tpu_torch.presets import get_experiment, get_preset
from cst_captioning_tpu_torch.rl import RewardComputer, SCSTTrainer
from cst_captioning_tpu_torch.rl import rollout_seed
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
from cst_captioning_tpu_torch.train import trainer as trainer_mod

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
# the step kernels' launches by kernel name (csrc/step.cuh, beam_step.cu)
STEP_LAUNCHES = {"step_q_gemm": "q", "step_attend": "attend",
                 "step_gates_gemm": "gates", "step_cell": "cell",
                 "step_logits": "logits", "beam_merge": "merge"}
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


def stride_inputs(model, dev, bf16: bool, seed: int = 1, B: int = CAPACITY,
                  K: int = K):
    """Serving-shaped stride inputs (or, with B=64 and K=1, the SCST
    decode's): B rows of ragged clips encoded by the model, some rows
    finished, a compaction prefix of B - 4, pages of 8 slots scattered over
    a pool in random order."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    G, F = 1 + K, cfg.max_frames
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
    finished[G - 1, 5] = True
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
        w=stride_weights(model.cell),  # packed once, as a serve or decode does
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
              min_len=0, mem_lens=x["mem_lens"], weights=x["w"])


def run_plain(name, model, x, return_gap=False):
    bank = x["dense"]
    if name.endswith("paged"):
        bank = gather_pages(*x["paged"])
    return decode_stride_plain(
        x["w"], x["carry"], x["token"], x["finished"],
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


STRIDE_PHASES = ("start", "init", "q", "attend", "gates", "cell", "logits",
                 "end")


def stride_phases(name, model, x) -> dict:
    """Device ms by phase of one stride launch on ``x`` (after a warm-up),
    from the kernel's own timeline: block 0's %globaltimer as it leaves
    each grid barrier, summed over the steps by phase."""
    dense = not name.endswith("paged")
    bank = x["dense"] if dense else x["paged"][:3]
    table = None if dense else x["paged"][3]
    slots, width = (bank[0].shape[1], 1) if dense else (
        bank[0].shape[1], table.shape[1])
    L = model.cfg.num_layers
    tl = torch.zeros(decode_stride.timeline_len(S, L), dtype=torch.int64,
                     device=bank[0].device)
    args = ("decode_stride_dense" if dense else "decode_stride_paged",
            x["w"], x["carry"], x["token"],
            x["finished"], *bank, table, slots, width, x["noise"], x["t0"],
            x["n_active"], S, 1.0, 0, x["mem_lens"])
    decode_stride._launch(*args)
    decode_stride._launch(*args, timeline=tl)
    torch.cuda.synchronize()
    ms = dict.fromkeys(STRIDE_PHASES[1:], 0.0)
    prev = None
    for code, t in tl.view(-1, 2).cpu().tolist():
        if t == 0:
            break
        if prev is not None:
            ms[STRIDE_PHASES[code]] += (t - prev) / 1e6
        prev = t
    return {**ms, "total": sum(ms.values())}


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


ATT_SHAPES = {"b64": "xe_b64", "b320": "update_b320", "m1000": "long_m1000"}
L2_BYTES = 50e6          # the H100's L2 cache


def check_attention(tmodel, corpus, tcfg) -> tuple[dict, float]:
    """Kernel 1 against its plain version at the XE step's B=64, the
    update's B=320 and M=1000, float32 and bfloat16, one kernel_check
    line each -> (the inputs by (shape, dtype), the largest error)."""
    att, worst = {}, 0.0
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
            worst = max(worst, res["max_abs_err"])
            att[label, dtype] = x
    return att, worst


def cold_copies(x, total=2 * L2_BYTES) -> list:
    """Copies of the inputs ``x`` whose bytes together exceed ``total``: a
    call that rotates through them finds its inputs out of L2."""
    nbytes = sum(t.numel() * t.element_size() for t in x)
    return [tuple(t.clone() for t in x)
            for _ in range(int(total // nbytes) + 2)]


def attention_device_ms(fn, reps: int = 10) -> float:
    """Device ms a call of ``fn`` spends in the attention kernel, from
    torch.profiler over ``reps`` calls after a warm-up; the kernel must
    appear once a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms, count = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") \
                and "additive_attention_kernel" in e.key:
            ms += e.self_device_time_total / 1e3
            count += e.count
    check(count == reps, f"attention launches seen by the profiler {count}, "
          f"expected {reps}")
    return ms / reps


def as_decoder_inputs(x) -> tuple:
    """``x`` as the teacher-forced decoder passes them: q, v, memory and
    memory_proj need gradients (the query and score layers' outputs and
    the encoder's), so a call goes through the autograd Function."""
    return tuple(t.detach().requires_grad_(i < 4) for i, t in enumerate(x))


def attention_phases(x) -> dict:
    """Kernel 1 on ``x`` by device time, warm (the same inputs again: L2
    holds them up to B=320) and cold (rotating through ``cold_copies``),
    and by cold CUDA-event time (median of 40 calls)."""
    copies = [as_decoder_inputs(c) for c in cold_copies(x)]
    it = itertools.cycle(copies)
    cold = lambda: fused_additive_attention(*next(it))  # noqa: E731
    return {"device_ms": attention_device_ms(
                lambda: fused_additive_attention(*x)),
            "cold_device_ms": attention_device_ms(cold),
            "cold_ms": float(np.median(event_times(cold, reps=40))),
            "cold_copies": len(copies)}


def time_attention(att: dict, smi: str) -> dict:
    """Kernel 1 at the bfloat16 shapes, on ``as_decoder_inputs``: CUDA-event
    medians in turns with the plain version (warm), ``attention_phases``,
    the bound and the shares (bound over each time; the warm ones can pass
    1, since L2 holds the inputs), one attention_phases line each ->
    {shape: dict}."""
    xs = {k: as_decoder_inputs(att[label, torch.bfloat16])
          for k, label in ATT_SHAPES.items()}
    times = time_in_turns({
        k: (lambda x=x: fused_additive_attention(*x),
            lambda x=x: additive_attention_plain(*x)) for k, x in xs.items()})
    clocks = smi_query("clocks.sm,power.draw")
    res = {}
    for k, x in xs.items():
        bnd, by = attention_bound(x)
        ph = attention_phases(x)
        ms, plain_ms = times[k]
        res[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                  "bound_by": by, **ph, "share": bnd / ms,
                  "device_share": bnd / ph["device_ms"],
                  "cold_share": bnd / ph["cold_ms"],
                  "cold_device_share": bnd / ph["cold_device_ms"]}
        emit({"phase": "attention_phases", "kernel": "fused_additive_attention",
              "shape": k, "rows": x[0].shape[0], "slots": x[2].shape[1],
              **res[k], "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    return res


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
                # the search's selection workspace, allocated once
                logits=torch.empty(
                    (beam_workspace(BEAM_W, TRAIN_B, model.cfg.vocab_size),),
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
            rl_scaled, "rl_loss_gate": BF16_ROUND,
            "rl_loss_rel_err": rel_err(km["rl_loss"], pm["rl_loss"]),
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


def step_phases(fn, layers: int, beam: bool, reps: int = 10) -> dict:
    """Device ms a call of the decode-step (or, with ``beam``, the
    beam-step) kernel spends in each of its launches, from torch.profiler
    over ``reps`` calls of ``fn`` after a warm-up; ``total`` is their sum
    and ``other`` the wrapper's own device work (casts) beside them. Each
    launch must appear as often as the step runs it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    want = {"q": 1, "attend": 1, "gates": layers, "cell": layers,
            "logits": 1, **({"merge": 1} if beam else {})}
    ms = dict.fromkeys(want, 0.0)
    count = dict.fromkeys(want, 0)
    other = 0.0
    for e in prof.key_averages():
        if not (str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0):
            continue
        phase = next((v for k, v in STEP_LAUNCHES.items() if k in e.key),
                     None)
        if phase is None:
            other += e.self_device_time_total / 1e3 / reps
            continue
        ms[phase] += e.self_device_time_total / 1e3 / reps
        count[phase] += e.count
    check(count == {k: n * reps for k, n in want.items()},
          f"step launches seen by the profiler {count}, expected "
          f"{want} x {reps}")
    return {**ms, "total": sum(ms.values()), "other": other}


# ---- phase 8: the recipe through the CLIs, from files ----------------------

# a template-style corpus in the port's feature format: msrvtt modalities,
# 28 frames, 200 words, 384 / 64 / 128 clips, 5 captions a clip
RECIPE_CORPUS = dict(num_videos=576, num_topics=8, vocab_words=200,
                     captions_per_video=5, caption_len=(5, 10),
                     max_frames=28, splits=(0.667, 0.112), seed=17,
                     caption_style="template", feature_noise=0.05)
RESUME_LOSS_TOL = 1e-3   # the embedding backward's atomics: not bitwise
RECIPE_DEVICE = "cuda"
INFO_KEYS = ("epoch", "xe_epochs", "phase", "batch_index", "global_step")


def recipe_corpus(root: str) -> dict:
    """The corpus through ``data.synthetic``, then its WXE weights and
    CIDEr df through ``data.preprocess``."""
    mods = dict(get_preset("msrvtt_xe_attention").modalities)
    t = time.perf_counter()
    paths = make_synthetic_dataset(os.path.join(root, "data"),
                                   modalities=mods, **RECIPE_CORPUS)
    info = json.load(open(paths["info_json"]))
    tok = {v["id"]: [c.split() for c in v["captions"]]
           for v in info["videos"] if v["split"] == "train"}
    paths["consensus_weights"] = os.path.join(root, "data", "weights.npz")
    np.savez(paths["consensus_weights"], **compute_consensus_weights(tok))
    paths["cider_df"] = os.path.join(root, "data", "cider_df.npz")
    compute_cider_df(tok).save(paths["cider_df"])
    splits = {s: sum(v["split"] == s for v in info["videos"])
              for s in ("train", "val", "test")}
    check(splits == {"train": 384, "val": 64, "test": 128},
          f"recipe corpus splits {splits}")
    paths["meta"] = {"clips": splits, "words": len(info["vocab"]) - 4,
                     "feature_bytes": sum(os.path.getsize(paths[n])
                                          for n in mods),
                     "write_s": time.perf_counter() - t}
    return paths


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


class BatchTap:
    """Stands in for the trainer's ``prefetch_to_device``: records every
    batch's video ids by epoch, and holds the first batch of each epoch,
    staged by the prefetch thread on its side stream, against a blocking
    copy of the same batch."""

    def __init__(self):
        self.real = prefetch_mod.prefetch_to_device
        self.epochs: list = []       # (kind, [video ids of each batch])
        self.checked = 0

    def __call__(self, it, size=2, transform=None, place=True,
                 stop_event=None, device=None):
        it = iter(it)
        first = next(it, None)
        if first is None:
            return
        want = prefetch_mod.place_blocking(transform(first), device)
        ids: list = []
        self.epochs.append(("xe" if len(want) == 6 else "rl", ids))

        def source():
            for b in itertools.chain([first], it):
                ids.append(list(b.video_ids))
                yield b

        for k, out in enumerate(self.real(source(), size, transform, place,
                                          stop_event, device)):
            if k == 0:
                check(_same(out, want), "a prefetched batch differs from "
                      "its blocking copy")
                self.checked += 1
            yield out


class ValidationTap:
    """Wraps the Evaluator's greedy decode: the decode-step launches of
    the validations against their decode steps (one lane, G=1)."""

    def __init__(self):
        self.real = evaluator_mod.greedy_decode
        self.launches = self.steps = 0

    def __call__(self, model, feats, masks, max_len=None, min_len=0):
        before = fused_decode_step.launches
        out = self.real(model, feats, masks, max_len=max_len,
                        min_len=min_len)
        self.launches += fused_decode_step.launches - before
        self.steps += decode_depth(out[0].cpu().numpy(),
                                   max_len or model.cfg.max_len)
        return out


def run_train(argv: list, log: str) -> dict:
    """``cli.train.main(argv)`` with every launch count set to 0 just
    before and read just after; -> the trainer, its events, the launches,
    the batches by epoch and the validations' decode launches."""
    tap, vtap = BatchTap(), ValidationTap()
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(trainer_mod, "prefetch_to_device", tap), \
            mock.patch.object(evaluator_mod, "greedy_decode", vtap):
        tr = cli_train.main(argv + ["--log-jsonl", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = all_launches()
    events = [json.loads(line) for line in open(log)]
    check(tap.checked == len(tap.epochs) > 0, "prefetch check missed epochs")
    return {"trainer": tr, "events": events, "launches": n, "wall_s": wall,
            "epochs": tap.epochs, "val_launches": vtap.launches,
            "val_steps": vtap.steps}


def _ev(run, name) -> list:
    return [e for e in run["events"] if e["event"] == name]


def _infos(ckpt_dir: str, name: str = "latest") -> dict:
    infos = json.load(open(os.path.join(ckpt_dir, name, "infos.json")))
    return {k: infos[k] for k in INFO_KEYS}


def _resume_gates(label, got_ids, want_ids, got_loss, want_loss, got_infos,
                  want_infos) -> float:
    check(got_ids == want_ids, f"{label}: the resumed run's batches differ")
    check(got_infos == want_infos,
          f"{label}: infos {got_infos} != {want_infos}")
    check(len(got_loss) == len(want_loss) > 0, f"{label}: step counts")
    worst = max(rel_err(a, b) for a, b in zip(got_loss, want_loss))
    check(worst <= RESUME_LOSS_TOL, f"{label}: step loss relative error "
          f"{worst:.3e} > {RESUME_LOSS_TOL}")
    return worst


def profile_rl_epoch(trainer, pipelined: bool) -> dict:
    """Device busy and idle share of one CST epoch of the trained state
    (its batches staged on the card first), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = trainer.cfg
    state = trainer.state.clone()
    scst = SCSTTrainer(state.model, trainer.reward, cfg.rl,
                       max_len=cfg.model.max_len, guard=True)
    batcher = Batcher(trainer.train_ds, batch_size=cfg.data.batch_size,
                      max_len=cfg.model.max_len, mode="video")
    batches = list(trainer._rl_device_batches(batcher))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, ms = scst.train_epoch(state, iter(batches),
                                 lambda j: rollout_seed(1, 0, 0, j),
                                 pipelined=pipelined)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    out = device_breakdown(prof, wall_ms)
    del out["top"]
    out.update(pipelined=pipelined, steps=len(ms),
               clips_per_s=len(ms) * cfg.data.batch_size / (wall_ms / 1e3))
    return out


def meanpool_attention(trainer) -> dict:
    """Kernel 1 at M=1 (the mean-pool encoder's bank) against its plain
    version on the trained model's encoder output, float32 and bfloat16,
    within the existing tolerances."""
    model = trainer.model
    batch = next(Batcher(trainer.train_ds, batch_size=TRAIN_B,
                         max_len=model.cfg.max_len, mode="caption")
                 .epoch(shuffle=False))
    corpus = {"feats": {n: torch.from_numpy(v).to(model.device)
                        for n, v in batch.feats.items()},
              "masks": {n: torch.from_numpy(v).to(model.device)
                        for n, v in batch.feat_masks.items()}}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = attention_inputs(model, corpus, dtype, TRAIN_B)
        check(x[2].shape[1] == 1, f"mean-pool bank has {x[2].shape[1]} slots")
        res = compare_attention(x)
        emit({"phase": "kernel_check", "kernel": "fused_additive_attention",
              "shape": "meanpool_m1", "rows": x[0].shape[0], "slots": 1,
              "dtype": str(dtype)[6:], **res})
        worst = max(worst, res["max_abs_err"])
    return {"max_abs_err": worst}


def recipe_phase(smi: str) -> tuple[dict, dict]:
    """Phase 8 in a temporary directory -> (the recipe line, the launches
    of each kernel over the recipe's runs)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        return _recipe(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _recipe(root: str, smi: str) -> tuple[dict, dict]:
    t0 = time.perf_counter()
    data = recipe_corpus(root)
    d = lambda name: os.path.join(root, name)  # noqa: E731
    files = ["--info-json", data["info_json"],
             "--feature", f"resnet={data['resnet']}"]
    common = files + [
        "--feature", f"c3d={data['c3d']}", "--device", RECIPE_DEVICE,
        "--set", "model__attention_impl='pallas'",
        "--set", "model__decode_impl='pallas'",
        "--set", "train__log_every_steps=1",
        "--set", f"data__consensus_weights='{data['consensus_weights']}'",
        "--set", f"data__cider_df='{data['cider_df']}'"]
    T = get_preset("msrvtt_cst_consensus").max_len
    total = dict.fromkeys(all_launches(), 0)

    def add(n):
        for k, v in n.items():
            total[k] += v

    def train(preset, ckpt, log, *extra):
        run = run_train(["--preset", preset, *common, "--set",
                         f"train__ckpt_dir='{d(ckpt)}'", *extra], d(log))
        add(run["launches"])
        return run

    # -- XE (2 epochs) then CST (1 epoch) at msrvtt_cst_consensus ---------
    a = train("msrvtt_cst_consensus", "ck_a", "a.jsonl",
              "--set", "train__epochs=2", "--set", "rl__epochs=1")
    xe_steps, rl_steps = _ev(a, "xe_step"), _ev(a, "rl_step")
    n = a["launches"]
    check(n["fused_additive_attention"] == T * (len(xe_steps)
                                                + len(rl_steps)),
          f"recipe: {n['fused_additive_attention']} attention launches for "
          f"{len(xe_steps)} XE steps and {len(rl_steps)} updates")
    cst_decode = n["fused_decode_step"] - a["val_launches"]
    cst_steps = sum(e["decode_steps"] for e in rl_steps)
    check(cst_decode == cst_steps > 0, f"recipe: {cst_decode} CST "
          f"decode-step launches for {cst_steps} decode steps")
    check(a["val_launches"] == a["val_steps"] > 0,
          f"recipe: {a['val_launches']} validation decode-step launches for "
          f"{a['val_steps']} greedy steps")
    check(n["fused_decode_stride"] == n["fused_decode_stride_paged"]
          == n["fused_beam_step"] == 0, f"recipe launched others: {n}")
    vals = _ev(a, "validate")
    check(len(vals) == 3 and all(np.isfinite(v["cider_d"]) for v in vals),
          f"recipe validations {vals}")
    for name in ("best", "latest"):
        check(os.path.exists(os.path.join(d("ck_a"), name, "state.npz")),
              f"recipe: no {name} checkpoint")
    xe_ids = [ids for kind, ids in a["epochs"] if kind == "xe"]
    xe_loss = [e["loss"] for e in xe_steps]
    spe = len(xe_ids[0])
    # the XE phase's end: latest.prev, demoted by the CST epoch's save
    xe_infos = _infos(d("ck_a"), "latest.prev")
    saves = _ev(a, "ckpt_epoch")

    # -- resume: 1 epoch, then resume="auto" to 2 (a mid-epoch save on
    # the way), then from that mid-epoch save alone ------------------------
    no_rl = ("--set", "rl__enabled=False")
    b1 = train("msrvtt_cst_consensus", "ck_b", "b1.jsonl",
               "--set", "train__epochs=1", *no_rl)
    mid = spe + 2
    b2 = train("msrvtt_cst_consensus", "ck_b", "b2.jsonl",
               "--set", "train__epochs=2", "--set", "train__resume='auto'",
               "--set", f"train__ckpt_every_steps={mid}", *no_rl)
    ids_b = [ids for _, ids in b1["epochs"] + b2["epochs"]]
    loss_b = [e["loss"] for e in _ev(b1, "xe_step") + _ev(b2, "xe_step")]
    err_b = _resume_gates("resume", ids_b, xe_ids, loss_b, xe_loss,
                          _infos(d("ck_b")), xe_infos)
    step_ck = f"step_{mid:08d}"
    check(json.load(open(os.path.join(d("ck_b"), step_ck, "infos.json")))
          ["batch_index"] == 2, "the mid-epoch save's batch index")
    os.makedirs(d("ck_c"))
    shutil.copytree(os.path.join(d("ck_b"), step_ck),
                    os.path.join(d("ck_c"), step_ck))
    c = train("msrvtt_cst_consensus", "ck_c", "c.jsonl",
              "--set", "train__epochs=2", "--set", "train__resume='auto'",
              *no_rl)
    err_c = _resume_gates(
        "mid-epoch resume", [ids for _, ids in c["epochs"]],
        [xe_ids[1][2:]], [e["loss"] for e in _ev(c, "xe_step")],
        xe_loss[mid:], _infos(d("ck_c")), xe_infos)
    restores = [e["restore_ms"] for r in (b2, c) for e in _ev(r, "resume")]

    # -- SCST: greedy baseline from the XE best ------------------------------
    sd = train("msrvtt_scst", "ck_d", "d.jsonl", "--skip-xe",
               "--set", f"rl__init_from='{d('ck_a')}'", "--set", "rl__epochs=1")
    S = get_preset("msrvtt_scst").decode_stride
    s_steps = _ev(sd, "rl_step")
    strides = sum(-(-e["decode_steps"] // S) for e in s_steps)
    n = sd["launches"]
    check(n["fused_decode_stride"] == strides > 0, f"recipe SCST: "
          f"{n['fused_decode_stride']} stride launches for {strides} strides")
    check(n["fused_additive_attention"] == T * len(s_steps),
          f"recipe SCST: {n['fused_additive_attention']} attention launches "
          f"for {len(s_steps)} updates")
    check(n["fused_decode_step"] == sd["val_launches"] == sd["val_steps"],
          f"recipe SCST: decode-step launches {n} outside validation")
    check(bool(_ev(sd, "handoff")), "recipe SCST: no handoff")

    # -- eval: beam 5 on the XE best ----------------------------------------
    steps, counting = counted_beam_steps()
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    with counting, contextlib.redirect_stdout(sys.stderr):
        res = cli_eval.main(["--preset", "msrvtt_eval_beam5", *files,
                             "--feature", f"c3d={data['c3d']}",
                             "--device", RECIPE_DEVICE,
                             "--set", "model__decode_impl='pallas'",
                             "--ckpt-dir", d("ck_a"), "--ckpt-name", "best",
                             "--results-json", d("results.json")])
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t
    n = all_launches()
    add(n)
    check(n["fused_beam_step"] == steps[0] > 0, f"recipe eval: "
          f"{n['fused_beam_step']} beam-step launches for {steps[0]} steps")
    metrics = res["metrics"]
    check(len(metrics) == 8 and all(np.isfinite(v) for v in metrics.values())
          and len(res["captions"]) == 128, f"recipe eval metrics {metrics}")

    # -- mean-pool: one XE epoch of msvd_xe_meanpool -------------------------
    e = run_train(["--preset", "msvd_xe_meanpool", *files,
                   "--device", RECIPE_DEVICE,
                   "--set", "model__attention_impl='pallas'",
                   "--set", "train__epochs=1", "--set",
                   "train__log_every_steps=1",
                   "--set", f"train__ckpt_dir='{d('ck_e')}'"], d("e.jsonl"))
    add(e["launches"])
    e_steps = _ev(e, "xe_step")
    # decode_impl "xla": the validation's greedy steps run the decoder
    # cell module, whose attention is kernel 1 too
    check(e["launches"]["fused_additive_attention"]
          == e["trainer"].cfg.model.max_len * len(e_steps) + e["val_steps"]
          and e["val_steps"] > 0 and len(e_steps) > 0,
          f"mean-pool: {e['launches']} for {len(e_steps)} steps and "
          f"{e['val_steps']} validation decode steps")
    m1 = meanpool_attention(e["trainer"])

    # -- device idle share of a pipelined and a sequential CST epoch --------
    idle = {("pipelined" if p else "sequential"):
            profile_rl_epoch(a["trainer"], p) for p in (True, False)}

    rate = lambda run, name: [x["clips_per_s"] for x in _ev(run, name)]  # noqa: E731
    line = {
        "phase": "recipe", "preset": "msrvtt_cst_consensus",
        "corpus": data["meta"], "batch": a["trainer"].cfg.data.batch_size,
        "steps_per_epoch": spe,
        "xe_clips_per_s": rate(a, "xe_epoch"),
        "cst_clips_per_s": rate(a, "rl_epoch"),
        "scst_clips_per_s": rate(sd, "rl_epoch"),
        "meanpool_xe_clips_per_s": rate(e, "xe_epoch"),
        "xe_step_ms_median": [x["step_ms_median"] for x in _ev(a, "xe_epoch")],
        "cst_step_ms_median": [x["step_ms_median"]
                               for x in _ev(a, "rl_epoch")],
        "validation_ms": [v["ms"] for v in vals],
        "ckpt_save_ms": [x["ms"] for x in saves],
        "ckpt_save_bytes": [x["bytes"] for x in saves],
        "ckpt_step_save_ms": [x["ms"] for x in _ev(b2, "ckpt_step")],
        "ckpt_restore_ms": restores,
        "cst_epoch_profile": idle,
        "eval_wall_s": eval_wall, "eval_metrics": metrics,
        "cider_d_after_xe": vals[1]["cider_d"],
        "cider_d_after_cst": vals[2]["cider_d"],
        "scst_cider_d": [v["cider_d"] for v in _ev(sd, "validate")],
        "resume_loss_rel_err": err_b, "mid_epoch_resume_loss_rel_err": err_c,
        "meanpool_attention_max_abs_err": m1["max_abs_err"],
        "launches": dict(total), "wall_s": time.perf_counter() - t0,
        "nvidia_smi": smi}
    return line, total


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
    # the SCST decode's stride: lane 0 greedy + 1 rollout over 64 clips
    scst_x = stride_inputs(model, dev, True, seed=6, B=TRAIN_B, K=1)
    res = compare("fused_decode_stride", model, scst_x)
    emit({"phase": "kernel_check", "kernel": "fused_decode_stride",
          "shape": "scst_g2_b64", "bank_dtype": "bfloat16", **res})
    record("fused_decode_stride", res)
    att, err = check_attention(tmodel, corpus, tcfg)
    record("fused_additive_attention", {"max_abs_err": err})
    for bf16, G in ((False, None), (True, 1), (True, None)):
        x = step_inputs(tmodel, corpus, bf16, G=G)
        res = compare_step(tmodel, x)
        emit({"phase": "kernel_check", "kernel": "fused_decode_step",
              "lanes": x["token"].shape[0], "rows": x["token"].shape[1],
              "bank_dtype": "bfloat16" if bf16 else "float32", **res})
        record("fused_decode_step", res)
        if G == 1:
            step_x1 = x                 # greedy decoding's shape
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

    pairs = {k: (lambda k=k: run_kernel(k, model, timed[k]),
                 lambda k=k: run_plain(k, model, timed[k])) for k in KERNELS}
    pairs.update({
        "fused_decode_stride_scst": (
            lambda: run_kernel("fused_decode_stride", model, scst_x),
            lambda: run_plain("fused_decode_stride", model, scst_x)),
        "fused_decode_step": (lambda: run_step_kernel(tmodel, step_x),
                              lambda: run_step_plain(step_x)),
        "fused_decode_step_g1": (lambda: run_step_kernel(tmodel, step_x1),
                                 lambda: run_step_plain(step_x1)),
        "fused_beam_step": (lambda: run_beam_kernel(emodel, beam_x),
                            lambda: run_beam_plain(beam_x)),
    })
    times = time_in_turns(pairs)
    clocks = smi_query("clocks.sm,power.draw")
    bounds = {k: bound_ms(k, model, timed[k], run_kernel(k, model,
                                                         timed[k])[1])
              for k in KERNELS}
    bounds["fused_decode_stride_scst"] = bound_ms(
        "fused_decode_stride", model, scst_x,
        run_kernel("fused_decode_stride", model, scst_x)[1])
    bounds.update(fused_decode_step=step_bound(tmodel, step_x),
                  fused_decode_step_g1=step_bound(tmodel, step_x1),
                  fused_beam_step=beam_bound(emodel, beam_x))
    for key, (ms, plain_ms) in times.items():
        bnd, by = bounds[key]
        emit({"phase": "kernel_time", "kernel": key, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
              "bound_share": bnd / ms,
              "clocks_sm_power_draw": clocks, "nvidia_smi": smi})
    for k in KERNELS + ("fused_decode_step", "fused_beam_step"):
        kernels[k].update(ms=times[k][0], plain_ms=times[k][1],
                          bound_ms=bounds[k][0], bound_by=bounds[k][1])
    # the kernels line carries the update's shape for the attention kernel
    # and the XE step's and M=1000 beside it
    att_t = time_attention(att, smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, label in ATT_SHAPES.items():
        q, _, mem = att[label, torch.bfloat16][:3]
        att_t[k]["n_e"], att_t[k]["passes"] = attention_ops.attention_split(
            q.shape[0], mem.shape[2], mem.element_size(), sms)
    kernels["fused_additive_attention"].update(
        att_t["b320"], b64=att_t["b64"], m1000=att_t["m1000"])
    for key, x in (("fused_decode_stride_paged", timed[KERNELS[1]]),
                   ("fused_decode_stride_scst", scst_x)):
        emit({"phase": "stride_phases", "kernel": key,
              **stride_phases(key, model, x), "nvidia_smi": smi})
    L, eL = tmodel.cfg.num_layers, emodel.cfg.num_layers
    phases = {
        "fused_decode_step": step_phases(
            lambda: run_step_kernel(tmodel, step_x), L, beam=False),
        "fused_decode_step_g1": step_phases(
            lambda: run_step_kernel(tmodel, step_x1), L, beam=False),
        "fused_beam_step": step_phases(
            lambda: run_beam_kernel(emodel, beam_x), eL, beam=True)}
    for key, ph in phases.items():
        emit({"phase": "step_phases", "kernel": key, "device_ms": ph,
              "event_ms": times[key][0], "nvidia_smi": smi})
    for k in ("fused_decode_step", "fused_beam_step"):
        kernels[k].update(device_ms=phases[k]["total"],
                          device_phases_ms=phases[k])
    kernels["fused_decode_step"]["g1"] = {
        "ms": times["fused_decode_step_g1"][0],
        "plain_ms": times["fused_decode_step_g1"][1],
        "bound_ms": bounds["fused_decode_step_g1"][0],
        "bound_by": bounds["fused_decode_step_g1"][1],
        "device_ms": phases["fused_decode_step_g1"]["total"]}
    del att, step_x, step_x1, beam_x, scst_x, pairs

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

    # ---- phase 8: the recipe through the CLIs, from files -------------------
    del model, tmodel, emodel, smodel, trainer, s_trainer, state, rl_state
    del s_state
    torch.cuda.empty_cache()
    recipe, recipe_launches = recipe_phase(smi)
    emit(recipe)
    for k, v in recipe_launches.items():
        path_launches[k] += v
    record("fused_additive_attention",
           {"max_abs_err": recipe["meanpool_attention_max_abs_err"]})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE[k],
         "replaces": REPLACES[k], "launches": path_launches[k],
         "library_ms": None, **v}
        for k, v in kernels.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
