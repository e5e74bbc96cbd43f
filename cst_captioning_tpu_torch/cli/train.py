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

Data parallel: one process a device, launched by torchrun, each rank on
``cuda:<LOCAL_RANK>`` (NCCL; ``--device cpu`` uses gloo):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m cst_captioning_tpu_torch.cli.train --preset ... \
        --set mesh__num_devices=2

``--dist-init URL`` (e.g. ``file:///tmp/rdzv``) forms the group from that
URL and the ``RANK`` / ``WORLD_SIZE`` env instead of ``MASTER_ADDR`` /
``MASTER_PORT``.

Sequence parallel: ``--set mesh__seq_devices=S`` makes the N ranks a
``('data', 'seq')`` grid of N/S rows, each row's S ranks holding a shard
of every clip's frames (``model.max_frames`` and the ranks divide by S,
the batch by N/S; the kernels stay off, ``attention_impl`` and
``decode_impl`` "xla"):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m cst_captioning_tpu_torch.cli.train --preset msrvtt_xe_attention \
        ... --set mesh__num_devices=4 --set mesh__seq_devices=2

Model parallel: ``--set mesh__mp_devices=M`` makes the N ranks a
``('data', 'mp')`` grid of N/M rows of M ranks. The batch shards by the
data coordinate only, so a row's M ranks are replicas that take the row's
first rank's reduced gradients each step (the batch divides by N/M; M
divides the vocabulary, ``d_hidden`` and N). Only the sharded-vocab
decode, ``ops/decode_mp.py``, shards the vocabulary over a row:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m cst_captioning_tpu_torch.cli.train --preset msrvtt_cst_consensus \
        ... --set mesh__num_devices=4 --set mesh__mp_devices=2

The decoupled RL topology across ranks: the XE phase runs data parallel
on every rank, then each RL epoch splits the ranks into actors (the first
``round(N * rl.actor_fraction)``) and learners, each side clamped to a
divisor of the batch:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m cst_captioning_tpu_torch.cli.train --preset msrvtt_cst_consensus \
        ... --set mesh__num_devices=4 \
        --set train__rl_topology="'decoupled'" --set rl__actor_fraction=0.5

The trainer logs the plan as an ``rl_split`` event (``actors``,
``learners``: global ranks; ``shared`` for one rank or the strict
schedule), e.g. ``{"event": "rl_split", "actors": [0, 1], "learners":
[2, 3], "shared": false}``.

Elastic training: with ``--set train__health=True --set
train__elastic="'degraded'"`` (and a ``train__health_dir`` every host
shares) the survivors of a lost rank go on at the smaller world. To bring
the host back, start its rank again with the same command and the same
``RANK`` / ``WORLD_SIZE``: it finds its tombstone in the health directory,
forms no launch group, and joins the survivors' next generation at their
next batch boundary (a ``rejoined`` event, and ``mesh_regrow`` on the
survivors). Under ``--dist-init`` pass the same URL; it is not used.
"""

from __future__ import annotations

import argparse
import os

import torch

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.cli.common import (
    add_common_args,
    load_config,
    open_dataset,
)
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.trainer import Trainer, is_rejoining


def main(argv: list[str] | None = None) -> Trainer:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--skip-xe", action="store_true",
                   help="run only the RL phase")
    args = p.parse_args(argv)
    cfg = load_config(args)
    # the process group before any CUDA work: NCCL binds the local rank. A
    # host the run lost and that comes back joins the survivors instead
    rank, world = (int(os.environ.get(k, d)) for k, d in
                   (("RANK", "0"), ("WORLD_SIZE", "1")))
    if world > 1 and is_rejoining(cfg, rank):
        multihost.set_identity(
            rank, world, "nccl" if torch.device(args.device).type == "cuda"
            else "gloo")
    else:
        multihost.initialize(args.dist_init, device=args.device)
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
                # a rejoiner holds the survivors' state already
                if cfg.rl.init_from and not trainer.rejoined:
                    trainer.load_params_from(cfg.rl.init_from, "best")
                trainer.train_rl()
        finally:
            trainer.close()
    finally:
        obs.shutdown()
        multihost.shutdown()
    return trainer


if __name__ == "__main__":
    main()
