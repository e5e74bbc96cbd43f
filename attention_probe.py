#!/usr/bin/env python3
"""The additive-attention kernel (kernel 1) of one checkout, on one GPU.

    python3 attention_probe.py [CHECKOUT]

Builds the additive-attention kernel of CHECKOUT (default: the directory
of this file), checks it against its plain version at chip_smoke's three
shapes and times it there, with this directory's chip_smoke.py: its
kernel_check and attention_phases lines, then the card's nvidia-smi line
and ``{"ok": true, ...}``. To hold an earlier commit's kernel against this
one on one card, unpack that commit (``git archive``) into a directory
that .gitignore lists and run the probe on both checkouts in turns:
earlier, this, this, earlier.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv: list[str]) -> int:
    if len(argv) > 1:
        print("usage: attention_probe.py [CHECKOUT]", file=sys.stderr)
        return 2
    checkout = os.path.abspath(argv[0] if argv else HERE)
    sys.path.insert(0, checkout)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch = smoke.torch
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smoke.smi_query("name,power.limit")
    smoke.build.build(["additive_attention"])
    smoke.emit({"phase": "device", "checkout": checkout,
                "package": os.path.dirname(smoke.attention_ops.__file__),
                "nvidia_smi": smi})
    tcfg = smoke.train_config()
    corpus = smoke.train_corpus(tcfg, dev)
    att, _ = smoke.check_attention(smoke.train_model(tcfg, corpus, dev),
                                   corpus, tcfg)
    smoke.time_attention(att, smi)
    print(smi, flush=True)
    smoke.emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
