"""Training CLI: the XE phase and/or the CST phase of a preset.

    # stage 1: cross-entropy
    python -m cst_captioning_tpu_torch.cli.train --preset msrvtt_xe_attention \\
        --info-json data/info.json --feature resnet=data/resnet.npy \\
        --feature c3d=data/c3d.npy --set train__ckpt_dir="'ckpt/xe'"
    # stage 2: CST from the best XE checkpoint
    python -m cst_captioning_tpu_torch.cli.train --preset msrvtt_cst_consensus \\
        ... --skip-xe --set rl__init_from="'ckpt/xe'"

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions.
``--obs DIR`` writes the run's observability stream (report it with
``cli.obs_report DIR``); ``--profile DIR`` writes torch.profiler traces.
"""

from __future__ import annotations

import argparse

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.cli.common import (
    add_common_args,
    load_config,
    open_dataset,
)
from cst_captioning_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None) -> Trainer:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--skip-xe", action="store_true",
                   help="run only the RL phase")
    args = p.parse_args(argv)
    cfg = load_config(args)
    train_ds = open_dataset(args, cfg, "train")
    try:
        val_ds = open_dataset(args, cfg, "val")
    except ValueError as e:
        # only an absent val split is optional
        if "no videos for split" not in str(e):
            raise
        val_ds = None
    # the Trainer configures the obs recorder from cfg.train.obs; the CLI
    # owns finalization, so a failed or finished run still gets its
    # trace.json and final metrics snapshot (a no-op with obs off)
    try:
        trainer = Trainer(cfg, train_ds, val_ds, log_path=args.log_jsonl,
                          device=args.device)
        try:
            if not args.skip_xe:
                trainer.train_xe()
            if cfg.rl.enabled:
                if cfg.rl.init_from:
                    trainer.load_params_from(cfg.rl.init_from, "best")
                trainer.train_rl()
        finally:
            trainer.close()
    finally:
        obs.shutdown()
    return trainer


if __name__ == "__main__":
    main()
