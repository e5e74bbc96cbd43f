#!/usr/bin/env python3
"""The serve and XE numbers of two checkouts with obs off, in turns, on one
GPU.

    python3 obs_off_probe.py CHECKOUT_A CHECKOUT_B

Runs each checkout's own code in its own process, in the order A, B, B, A:
chip_smoke's serve burst (64 requests at msrvtt_xe_attention width,
capacity 32, K=2, S=8; a warm-up serve, then 5 timed ones) and two XE
epochs of ``msrvtt_cst_consensus`` (kernels on, no validation) on
chip_smoke's recipe corpus, written in a temporary directory. Obs stays
off: the numbers say whether a change moved the paths it did not mean to.
Prints one JSON line a run (requests/s of each serve, clips/s of each
epoch past its first step, the card's nvidia-smi line) and a last line
with each checkout's medians. Kernels build in each checkout at first use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

RUN = r"""
import json, os, shutil, tempfile, time
import torch
import chip_smoke as cs
from cst_captioning_tpu_torch.data import CaptionDataset
from cst_captioning_tpu_torch.ops import build
from cst_captioning_tpu_torch.presets import get_experiment, get_preset
from cst_captioning_tpu_torch.train.trainer import Trainer

torch.backends.cuda.matmul.allow_tf32 = False
build.build()
dev = torch.device("cuda")
model = cs.make_model(dev)
reqs = cs.requests(model.cfg)
cs.service(model).serve(reqs[:4])
rps = [cs.N_REQUESTS / cs.serve_timed(cs.service(model), reqs)[1]
       for _ in range(5)]
root = tempfile.mkdtemp(prefix="obs_off_probe_")
try:
    data = cs.recipe_corpus(root)
    mods = [n for n, _ in get_preset("msrvtt_cst_consensus").model.modalities]
    cfg = get_experiment("msrvtt_cst_consensus").override(
        model__attention_impl="pallas", model__decode_impl="pallas",
        train__epochs=2, rl__enabled=False,
        train__ckpt_dir=os.path.join(root, "ck"),
        data__consensus_weights=data["consensus_weights"])
    ds = CaptionDataset(data["info_json"], {n: data[n] for n in mods},
                        "train", max_frames=cfg.model.max_frames,
                        consensus_weights=cfg.data.consensus_weights)
    log = os.path.join(root, "log.jsonl")
    tr = Trainer(cfg, ds, None, log_path=log, device="cuda")
    tr.train_xe()
    tr.close()
    clips = [e["clips_per_s"] for e in map(json.loads, open(log))
             if e["event"] == "xe_epoch"]
finally:
    shutil.rmtree(root, ignore_errors=True)
print(json.dumps({"requests_per_s": rps, "xe_clips_per_s": clips,
                  "nvidia_smi": cs.smi_query("name,power.limit")}))
"""


def run(checkout: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=checkout,
                         capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise SystemExit(f"{checkout}: exited {out.returncode}\n"
                         f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    line["checkout"] = checkout
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    a, b = sys.argv[1:3]
    for c in (a, b):
        if not os.path.exists(os.path.join(c, "chip_smoke.py")):
            raise SystemExit(f"{c}: no chip_smoke.py")
    runs = [run(c) for c in (a, b, b, a)]
    summary = {}
    for c in (a, b):
        mine = [r for r in runs if r["checkout"] == c]
        summary[c] = {
            "median_requests_per_s": float(np.median(
                [x for r in mine for x in r["requests_per_s"]])),
            "median_xe_clips_per_s": float(np.median(
                [x for r in mine for x in r["xe_clips_per_s"]]))}
    print(json.dumps({"turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
