"""CST through ``SCSTTrainer.train_epoch`` (pipelined), fed by
``Batcher`` (mode ``video``) through ``prefetch_to_device``, scored by
the consensus reward ``RewardComputer``; a step is one emitted update.

``judge`` follows the first three steps with the plain reference and
reads, besides ``checks.training_gaps``:

- ``feed_order``: 1 where a step's clips are not the batch order's;
- ``loss_gap``: each step's REINFORCE loss, ``|L_port - L_ref|`` over
  the mean of ``|advantage * logprob|`` over the tokens (the loss's own
  mean is near 0), the worst step;
- ``rollout_gap``: each sampled token under the reference at the
  decode's parameters, the widest gap by which its ``logit / T + noise``
  lies below the best token's (the noise worked out again from the
  batch's seed);
- ``reward_gap``: the widest difference between the port's consensus
  rewards and the reference's.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from benchmark import checks, drivers, faults
from benchmark import weights as bw
from benchmark.reference import model as rm
from benchmark.reference.noise import gumbel
from benchmark.reference.reward import ConsensusReward


def rollout_seed(seed: int, j: int) -> int:
    """Batch ``j``'s rollout-noise seed, from the run's seed."""
    return (int(seed) * 1_000_003 + 7919 * (j + 1)) & 0x7FFFFFFF


# ---- the timed path ---------------------------------------------------------

def drive(cell, run) -> drivers.Session:
    from cst_captioning_tpu_torch.data.batcher import Batcher
    from cst_captioning_tpu_torch.data.prefetch import prefetch_to_device
    from cst_captioning_tpu_torch.rl.rewards import RewardComputer
    from cst_captioning_tpu_torch.rl.scst import SCSTTrainer
    from cst_captioning_tpu_torch.train.schedule import make_optimizer
    from cst_captioning_tpu_torch.train.state import create_train_state

    run.mark("program imports")
    pool = cell.pool()
    ds = drivers.dataset(cell, pool)
    B = cell.batch
    run.mark("pool")
    model, w0 = drivers.build_model(cell, run)
    rl = cell.rl_config()
    tx = make_optimizer(cell.section("TrainConfig", "train"),
                        max(1, len(ds) // B), lr_override=rl.lr)
    state = create_train_state(model, tx, seed=run.seed)
    run.mark("model")
    reward = RewardComputer(
        ds.vocab, ds.gts_pool(), cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    run.mark("reward")
    scst = SCSTTrainer(model, reward, rl, max_len=int(cell.model["max_len"]))
    cap = {"w0": {k: v.clone() for k, v in w0.items()}, "samples": [],
           "rewards": [], "video_ids": [], "losses": [], "B": B,
           "K": rl.num_rollouts,
           "seeds": [rollout_seed(run.seed, j)
                     for j in range(drivers.CHECK_STEPS)],
           "pool": pool}
    decode, score = scst.decode, scst.reward

    def decode_capture(model_, feats, masks, seed, noise_fn=None):
        greedy, samples = decode(model_, feats, masks, seed, noise_fn)
        if not cap["samples"]:
            run.mark("first decode")
        if len(cap["samples"]) < drivers.CHECK_STEPS:
            cap["samples"].append(samples.detach().clone())
        return greedy, samples

    def reward_capture(video_ids, rows):
        r = score(video_ids, rows)
        if len(cap["rewards"]) < drivers.CHECK_STEPS:
            cap["rewards"].append(np.array(r, np.float64))
            cap["video_ids"].append([str(v) for v in video_ids])
        return r

    scst.decode, scst.reward = decode_capture, reward_capture
    batcher = Batcher(ds, B, int(cell.model["max_len"]), mode="video",
                      seed=run.seed)
    feed = prefetch_to_device(
        drivers.endless(batcher, shuffle=True),
        size=int(cell.traffic.get("prefetch", 2)),
        transform=lambda b: (b.feats, b.feat_masks, list(b.video_ids),
                             [bool(v) for v in b.valid]),
        device=run.device)
    run.mark("feed")
    spans = drivers.Spans(run) if run.trace else None
    win = drivers.Window(run, drivers.WARMUP_STEPS,
                         spans.open if spans else None)

    def on_step(m):
        win.tick()
        drivers.capture_step(win, cap, model, state, float(m["rl_loss"]))

    try:
        scst.train_epoch(state, feed, lambda j: rollout_seed(run.seed, j),
                         on_step=on_step, pipelined=True,
                         should_stop=win.should_stop)
    finally:
        feed.close()
    return win.finish(B, spans, cap)


# ---- the reference's verdict -------------------------------------------------

def reinforce(model, enc, samples, adv):
    """(loss, its scale) of REINFORCE on ``samples`` [K*B, T]."""
    logp = rm.token_logps(model, enc, samples)
    mask = (samples != rm.PAD_ID).float()
    den = mask.sum().clamp(min=1.0)
    loss = -(adv[:, None] * logp * mask).sum() / den
    scale = (adv[:, None].abs() * logp.abs() * mask).sum() / den
    return loss, float(scale.detach())


def advantages(r: np.ndarray, K: int, dev) -> torch.Tensor:
    """The self-consensus baseline: each rollout's reward less the mean of
    its clip's other rollouts', flattened [K*B]."""
    r_kb = r.reshape(K, -1)
    adv = r_kb - (r_kb.sum(0, keepdims=True) - r_kb) / (K - 1)
    return torch.tensor(adv.reshape(-1), dtype=torch.float32, device=dev)


@torch.no_grad()
def rollout_gap(model, enc, samples, seed: int, K: int, temperature: float):
    """The widest gap of a sampled token's ``logit / T + noise`` below the
    best one's, over the live positions of ``samples`` [K, B, T]."""
    _, B, T = samples.shape
    flat = samples.reshape(K * B, T).long()
    enc_k = rm.tile(enc, K)

    def each(t, logits):
        V = logits.shape[-1]
        z = rm.forbid_special(logits) / temperature \
            + gumbel(seed, K, B, V, t, logits.device).reshape(K * B, V)
        tok = flat[:, t]
        gap = z.max(-1).values - z.gather(-1, tok[:, None])[:, 0]
        return torch.where(tok != rm.PAD_ID, gap,
                           torch.zeros_like(gap)).max()

    return float(torch.stack(rm.teacher_force(model, enc_k, flat,
                                              each=each)).max())


def _setting(cell, pool):
    rl = cell.rl_config()
    reward = ConsensusReward(pool.refs(), rl.reward_cider_weight,
                             rl.reward_bleu4_weight, rl.reward_bleu4_scale)
    clip = float(cell.traffic["train"].get("grad_clip", 5.0))
    return rl, reward, clip


def judge(cell, cap, dev) -> dict:
    """The CST readings of a capture (the port's, or the control's)."""
    rm.tf32_off()
    pool = checks.pool_of(cell, cap["pool"])
    rl, reward, clip = _setting(cell, pool)
    K, B, T = cap["K"], cap["B"], int(cell.model["max_len"])
    order = pool.batches(len(cap["losses"]), B, cell.seed, "video")
    params = checks.leaves(cap["w0"])
    decode_params = [params, params]
    opt = checks.Adam(params, rl.lr, clip)
    loss_gap = roll = rew = 0.0
    feed_ok = True
    g1 = None
    for i in range(len(cap["losses"])):
        feats, masks, _, clips = pool.collate(order[i], T)
        feed_ok &= clips == cap["video_ids"][i]
        feats, masks = checks.to_dev(feats, dev), checks.to_dev(masks, dev)
        samples = cap["samples"][i].to(dev)
        dm = rm.RefModel(cell.model, decode_params[i])
        roll = max(roll, rollout_gap(dm, dm.encode(feats, masks), samples,
                                     cap["seeds"][i], K, rl.temperature))
        r = np.asarray(reward(clips, samples.reshape(K * B, T).cpu().numpy()),
                       np.float64)
        rew = max(rew, float(np.abs(r - cap["rewards"][i]).max()))
        model = rm.RefModel(cell.model, params)
        loss, scale = reinforce(model, rm.tile(model.encode(feats, masks), K),
                                samples.reshape(K * B, T).long(),
                                advantages(r, K, dev))
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        loss_gap = max(loss_gap, abs(cap["losses"][i] - loss.item())
                       / max(scale, 1e-30))
        grads = opt.clipped(grads)
        g1 = grads if g1 is None else g1
        params = opt.step(params, grads)
        decode_params.append(params)
    return {"feed_order": 0.0 if feed_ok else 1.0,
            "loss_gap": loss_gap,
            **checks.training_gaps(cap, g1, params, dev),
            "rollout_gap": roll,
            "reward_gap": rew}


# ---- the control: the reference in the port's place, in float8 --------------

def control(cell, seed: int, dev) -> dict:
    rm.tf32_off()
    pool_dir = cell.pool()
    pool = checks.pool_of(cell, pool_dir)
    rl, reward, clip = _setting(cell, pool)
    K, B, T = rl.num_rollouts, cell.batch, int(cell.model["max_len"])
    V = int(cell.model["vocab_size"])
    w0 = bw.make_weights(cell.model, seed, dev)
    params = checks.leaves(w0)
    order = pool.batches(drivers.CHECK_STEPS, B, seed, "video")
    opt = checks.Adam(params, rl.lr, clip)
    seeds = [rollout_seed(seed, j) for j in range(drivers.CHECK_STEPS)]
    cap = {"w0": w0, "samples": [], "rewards": [], "video_ids": [],
           "losses": [], "B": B, "K": K, "seeds": seeds, "pool": pool_dir}
    decode_params = [params, params]
    for i in range(drivers.CHECK_STEPS):
        feats, masks, _, clips = pool.collate(order[i], T)
        feats, masks = checks.to_dev(feats, dev), checks.to_dev(masks, dev)
        dm = rm.RefModel(cell.model, decode_params[i], rm.fp8_round)
        samples = rm.sample(dm, dm.encode(feats, masks), K, T, rl.temperature,
                            lambda t, s=seeds[i]: gumbel(s, K, B, V, t, dev))
        r = np.asarray(reward(clips, samples.reshape(K * B, T).cpu().numpy()))
        model = rm.RefModel(cell.model, params, rm.fp8_round)
        loss, _ = reinforce(model, rm.tile(model.encode(feats, masks), K),
                            samples.reshape(K * B, T), advantages(r, K, dev))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        grads = opt.clipped(grads)
        params = opt.step(params, grads)
        decode_params.append(params)
        cap["samples"].append(samples)
        cap["rewards"].append(r)
        cap["video_ids"].append(clips)
        cap["losses"].append(loss.item())
        if i == 0:
            cap["mu1"] = {k: 0.1 * g for k, g in grads.items()}
    cap["p3"] = {k: v.detach() for k, v in params.items()}
    return cap


# ---- faults planted under the timed path -------------------------------------

@contextlib.contextmanager
def half_batch():
    """The update's loss over the first half of the rows only."""
    from cst_captioning_tpu_torch.rl import scst

    orig = scst._decode_loss_sums

    def sums(model, enc, tokens, adv, valid):
        keep = torch.arange(len(valid), device=valid.device) \
            < len(valid) // 2
        return orig(model, enc, tokens, adv, valid * keep)

    with mock.patch.object(scst, "_decode_loss_sums", sums):
        yield


@contextlib.contextmanager
def token_altered():
    """The first sampled token of the first row moved to another word."""
    from cst_captioning_tpu_torch.rl import scst

    orig = scst.sample_decode

    def sample(model, *a, **k):
        tokens, logps = orig(model, *a, **k)
        out = tokens.clone()
        idx = (0,) * out.ndim
        V = model.cfg.vocab_size
        out[idx] = (int(out[idx]) - 4 + 1) % (V - 4) + 4
        return out, logps

    with mock.patch.object(scst, "sample_decode", sample):
        yield


@contextlib.contextmanager
def reward_altered():
    """The first consensus reward of each scoring call raised by 1."""
    from cst_captioning_tpu_torch.rl.rewards import RewardComputer

    orig = RewardComputer.__call__

    def call(self, video_ids, rows):
        out = orig(self, video_ids, rows)
        out[0] += 1.0
        return out

    with mock.patch.object(RewardComputer, "__call__", call):
        yield


FAULTS = {"unchanged": faults.unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "reward_altered": reward_altered}
