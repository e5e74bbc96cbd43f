#!/usr/bin/env python3
"""Kernels 2-5's outputs and times at chip_smoke's phase 2 shapes on
float32 parameters, from a checkout, on one GPU.

    python3 kernel_digest_probe.py [CHECKOUT]

CHECKOUT (default: this script's directory) is a checkout of the repo
whose ``chip_smoke.py`` and ``cst_captioning_tpu_torch`` the probe imports
and builds. It makes chip_smoke's seeded serve and train models, then calls
the stride kernel (dense and paged at the serve shapes, float32 and
bfloat16 banks; dense at the SCST shape), the decode step (G=5 with
float32 and bfloat16 banks, G=1) and the beam step (W=5, B=64, twice at
t=3 and once at t=1 with min_len=3) on the models' float32 weight packs,
and prints one JSON line: a sha256 (16 hex digits) of each call's
outputs (tokens, logprobs, logits, the stepped carry, beam scores and
ids) and each call's CUDA-event median over 20 calls. Two checkouts whose
kernels give the same bits print the same digests; run them in turns
(A, B, B, A), each in a process of its own, to compare their times.
The card's nvidia-smi line comes last.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if sys.argv[1:] else
                       os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cst_captioning_tpu_torch.ops import build  # noqa: E402


def digest(outputs) -> str:
    """sha256 over every tensor's dtype and bytes, in order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        else:
            h.update(str(x.dtype).encode())
            h.update(x.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    walk(outputs)
    return h.hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_digest_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    dev = torch.device("cuda")
    model = cs.make_model(dev)
    tcfg = cs.train_config()
    corpus = cs.train_corpus(tcfg, dev)
    tmodel = cs.train_model(tcfg, corpus, dev)
    calls = {}
    for bf16 in (False, True):
        x = cs.stride_inputs(model, dev, bf16)
        for k in cs.KERNELS:
            calls[f"{k}_{'bf16' if bf16 else 'f32'}_bank"] = (
                lambda k=k, x=x: cs.run_kernel(k, model, x), None)
    x = cs.stride_inputs(model, dev, True, seed=6, B=cs.TRAIN_B, K=1)
    calls["fused_decode_stride_scst"] = (
        lambda x=x: cs.run_kernel("fused_decode_stride", model, x), None)
    for bf16, G in ((False, None), (True, 1), (True, None)):
        x = cs.step_inputs(tmodel, corpus, bf16, G=G)
        key = (f"fused_decode_step_g{x['token'].shape[0]}_"
               f"{'bf16' if bf16 else 'f32'}_bank")
        calls[key] = (lambda x=x: cs.run_step_kernel(tmodel, x), x)
    for bf16, t, min_len in ((False, 3, 0), (True, 3, 0), (True, 1, 3)):
        x = cs.beam_inputs(tmodel, corpus, bf16, t, min_len)
        key = (f"fused_beam_step_t{t}_min_len{min_len}_"
               f"{'bf16' if bf16 else 'f32'}_bank")
        calls[key] = (lambda x=x: cs.run_beam_kernel(tmodel, x), x)
    digests, event_ms = {}, {}
    for key, (fn, x) in calls.items():
        if x is None:
            digests[key] = digest(fn())
        else:
            # a step's outputs with its carry stepped on a fresh stack
            state = cs.stack_carry(x["carry"])
            run = (cs.run_beam_kernel if "beam" in key
                   else cs.run_step_kernel)
            digests[key] = digest((run(tmodel, x, state), state))
        event_ms[key] = float(np.median(cs.event_times(fn)))
    torch.cuda.synchronize()
    print(json.dumps({"checkout": ROOT, "digests": digests,
                      "event_ms": event_ms,
                      "s": time.perf_counter() - t0}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
