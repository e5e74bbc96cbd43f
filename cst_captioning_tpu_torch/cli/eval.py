"""Evaluation CLI: decode a split (beam search by the preset) and print
the COCO-style metric table.

    python -m cst_captioning_tpu_torch.cli.eval --preset msrvtt_eval_beam5 \\
        --info-json data/info.json --feature resnet=data/resnet.npy \\
        --feature c3d=data/c3d.npy --ckpt-dir ckpt/cst --ckpt-name best

``--jax-ckpt DIR`` evaluates a checkpoint directory the JAX package wrote
(its ``state.msgpack``, read without flax or msgpack) instead of
``--ckpt-dir``. ``--obs DIR`` writes the eval's observability stream
(default dir ``obs_eval`` when only ``train.obs`` is set).

Under ``python -m torch.distributed.run --nproc-per-node N`` (or
``--dist-init``, as ``cli.train``) each rank decodes its rows of every
batch on ``cuda:<LOCAL_RANK>``, rank 0 scores and writes the results.
``--set mesh__seq_devices=S`` carries the training layout into the eval:
a ``('data', 'seq')`` grid of the N ranks, each holding its shard of the
frame axis (``parallel.seq_parallel``); ``--set mesh__mp_devices=M`` the
``('data', 'mp')`` grid, whose rows decode the same rows with the
replicated kernels, as the JAX evaluator does.
"""

from __future__ import annotations

import argparse
import json
import os

from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.ckpt import JAX_STATE_FILE, load_params
from cst_captioning_tpu_torch.cli.common import (
    add_common_args,
    load_config,
    open_dataset,
)
from cst_captioning_tpu_torch.eval.evaluator import evaluate_split
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import is_seq_grid, make_mesh


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-name", default="best")
    p.add_argument("--jax-ckpt", default="", metavar="DIR",
                   help="a checkpoint directory the JAX package wrote "
                        "(<ckpt_dir>/<name>, holding state.msgpack)")
    p.add_argument("--split", default="")
    p.add_argument("--results-json", default="results.json")
    args = p.parse_args(argv)
    if bool(args.ckpt_dir) == bool(args.jax_ckpt):
        raise SystemExit("give one of --ckpt-dir or --jax-ckpt")
    multihost.initialize(args.dist_init, device=args.device)
    cfg = load_config(args)
    split = args.split or cfg.eval.split
    if cfg.train.obs:
        # a standalone eval run gets its own obs stream (the Evaluator's
        # spans and gauges), reported with cli.obs_report like a training
        # run
        obs.configure(cfg.train.obs_dir or "obs_eval",
                      run=f"{cfg.name}-eval-{split}")
    try:
        return _evaluate(args, cfg, split)
    finally:
        obs.shutdown()
        multihost.shutdown()


def _evaluate(args, cfg, split: str) -> dict:
    # the dataset, the model and the checkpoint read: the run's setup, as
    # the trainer spells it
    with obs.span("setup"):
        ds = open_dataset(args, cfg, split)
        # seq_devices > 1 carries the training layout into the eval: the
        # frames shard over each seq row of the grid (an mp grid's rows
        # decode alike with the replicated kernels)
        mesh = (make_mesh(cfg.mesh.num_devices,
                          seq_devices=cfg.mesh.seq_devices,
                          mp_devices=cfg.mesh.mp_devices,
                          device=args.device)
                if multihost.is_multiprocess() or cfg.mesh.seq_devices > 1
                else None)
        model = CaptionModel(cfg.model, device=mesh.device if mesh
                             else args.device)
        if is_seq_grid(mesh):
            model.set_seq(mesh.seq)
        if args.jax_ckpt:
            if not os.path.exists(os.path.join(args.jax_ckpt,
                                               JAX_STATE_FILE)):
                raise SystemExit(f"--jax-ckpt {args.jax_ckpt}: no "
                                 f"{JAX_STATE_FILE} (not a JAX checkpoint)")
            load_params(*os.path.split(os.path.normpath(args.jax_ckpt)),
                        model)
        else:
            load_params(args.ckpt_dir, args.ckpt_name, model)
    result = evaluate_split(model, ds, cfg.eval,
                            batch_size=cfg.data.batch_size,
                            results_json=args.results_json, mesh=mesh)
    print(json.dumps(result["metrics"], indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
