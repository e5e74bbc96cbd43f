#!/usr/bin/env python3
"""Where the time of the decoupled and online RL paths goes, on one GPU.

    python3 rl_probe.py

Builds the kernels and fits chip_smoke's SCST model (``fitted_model`` on
the train corpus), then runs chip_smoke's two RL phases' workloads with the
obs spans on, each run in its own run directory, and prints one JSON line
a run with the ``cli.obs_report --json`` host rows (self time by span):

- decoupled: the ``rl_decoupled`` batches (6 of 64 at msrvtt_cst_consensus
  width, K=5, self-consensus baseline); a sync pipelined and a strict
  decoupled epoch in turns (sync, strict, strict, sync), clips/s each;
- online: the ``rl_online`` trace (256 requests, capacity 32, K=1, S=8);
  frozen and online serves in turns (frozen, online, online, frozen),
  requests/s each; the learner's publishes are timed apart (this script
  wraps ``publish_params`` in an ``rl.online.publish`` span);
- then one frozen and one online serve under torch.profiler: the device's
  busy time by kernel and its idle share.

The last lines are the card's nvidia-smi line and the medians.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from cst_captioning_tpu_torch import obs

DEVICE = "cuda"


def report(run_dir: str) -> dict:
    rc, out = cs.cli_stdout(cs.cli_obs_report.main, [run_dir, "--json"])
    cs.check(rc == 0, f"obs_report failed on {run_dir}")
    rep = json.loads(out)
    return {"wall_s": rep.get("wall_s"), "rows": cs.host_rows(rep, 10)}


def observed(root: str, name: str, fn):
    """Run ``fn`` with obs on in ``root/name`` -> (its result, report)."""
    obs.REGISTRY.reset()
    run_dir = os.path.join(root, name)
    obs.configure(run_dir, run=name)
    try:
        out = fn()
    finally:
        obs.shutdown()
    return out, report(run_dir)


def main() -> int:
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("rl_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_query("name,power.limit")
    cs.build.build()
    tcfg, scfg = cs.train_config(), cs.scst_config()
    corpus = cs.train_corpus(tcfg, dev)
    smodel, _ = cs.fitted_model(scfg, corpus, dev)
    fit_sd = {k: v.detach().clone() for k, v in smodel.state_dict().items()}
    del smodel, corpus
    host = cs.make_corpus(tcfg.model, cs.TRAIN_B, 5, seed=0)
    root = tempfile.mkdtemp(prefix="rl_probe_")
    medians = {}

    # ---- decoupled ----------------------------------------------------------
    rl = dataclasses.replace(tcfg.rl, pipelined=True)
    reward = cs.RewardComputer(
        host["vocab"], host["gts"], cider_weight=rl.reward_cider_weight,
        bleu_weight=rl.reward_bleu4_weight, bleu_scale=rl.reward_bleu4_scale,
        num_threads=rl.reward_threads)
    batches = cs.decoupled_batches(tcfg, host, dev)
    base = tcfg.train.seed + 1

    def epoch(kind):
        model = cs.CaptionModel(tcfg.model, device=dev)
        model.load_state_dict(fit_sd)
        state = cs.create_train_state(
            model, cs.make_optimizer(tcfg.train, 1, lr_override=rl.lr),
            seed=tcfg.train.seed)
        tr = (cs.SCSTTrainer(model, reward, rl, guard=True) if kind == "sync"
              else cs.AsyncSCSTTrainer(model, reward, rl, guard=True,
                                       strict=True))
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_epoch(state, batches,
                       lambda j: cs.rollout_seed(base, 0, 0, j))
        torch.cuda.synchronize()
        return cs.RL_BATCHES * cs.TRAIN_B / (time.perf_counter() - t)

    rates = {"sync": [], "strict": []}
    for k, kind in enumerate(("sync", "strict", "strict", "sync")):
        rate, rep = observed(root, f"decoupled_{k}_{kind}",
                             lambda: epoch(kind))
        rates[kind].append(rate)
        cs.emit({"probe": "decoupled", "kind": kind, "clips_per_s": rate,
                 **rep, "nvidia_smi": smi})
    medians["decoupled_clips_per_s"] = {k: float(np.median(v))
                                        for k, v in rates.items()}

    # ---- online -------------------------------------------------------------
    orl = dataclasses.replace(scfg.rl, **cs.ONLINE_RL)
    serve_cfg = cs.model_config()
    learn_cfg = dataclasses.replace(serve_cfg, attention_impl="pallas")
    reqs = cs.online_requests(host, serve_cfg)
    oreward = cs.RewardComputer(
        host["vocab"], host["gts"], cider_weight=orl.reward_cider_weight,
        bleu_weight=orl.reward_bleu4_weight,
        bleu_scale=orl.reward_bleu4_scale, num_threads=orl.reward_threads)

    def model_of(cfg):
        m = cs.CaptionModel(cfg, device=dev)
        m.load_state_dict(fit_sd)
        return m.eval()

    def service():
        return cs.CaptionService(model_of(serve_cfg), capacity=cs.CAPACITY,
                                 num_rollouts=orl.num_rollouts, stride=cs.S,
                                 frame_bucket=cs.FRAME_BUCKET, device=dev)

    def serve(kind):
        svc = service()
        if kind == "online":
            learner = model_of(learn_cfg)
            state = cs.create_train_state(
                learner, cs.make_optimizer(scfg.train, 1,
                                           lr_override=orl.lr),
                seed=scfg.train.seed)
            tr = cs.OnlineSCSTTrainer(
                learner, oreward, orl, state, guard=True,
                ref_id=lambda r: r.req_id.split("#")[0])
            tr.attach(svc)
            publish = svc.publish_params

            def timed(params, version=None):
                with obs.span("rl.online.publish"):
                    return publish(params, version=version)

            svc.publish_params = timed
        rep, wall = cs.serve_timed(svc, reqs)
        return len(rep.results) / wall

    rps = {"frozen": [], "online": []}
    for k, kind in enumerate(("frozen", "online", "online", "frozen")):
        rate, rep = observed(root, f"online_{k}_{kind}", lambda: serve(kind))
        rps[kind].append(rate)
        cs.emit({"probe": "online", "kind": kind, "requests_per_s": rate,
                 **rep, "nvidia_smi": smi})
    medians["online_requests_per_s"] = {k: float(np.median(v))
                                        for k, v in rps.items()}

    from torch.profiler import ProfilerActivity, profile
    for kind in ("frozen", "online"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            serve(kind)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        cs.emit({"probe": "online_profile", "kind": kind,
                 **cs.device_breakdown(prof, wall_ms), "nvidia_smi": smi})

    print(smi, flush=True)
    cs.emit({"medians": medians})
    return 0


if __name__ == "__main__":
    sys.exit(main())
