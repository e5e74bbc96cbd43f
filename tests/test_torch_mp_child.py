"""One rank of a ``('data', 'mp')`` grid of the PyTorch port, for
``tests/test_torch_model_parallel.py``. Not a test module: it holds no
test functions.

    python tests/test_torch_mp_child.py JOB RANK WORLD INIT_FILE ARGS OUT

forms a gloo group from ``file://INIT_FILE``, runs ``JOB(rank, world,
args)`` and pickles its result dict to ``OUT.rank<RANK>``, as
``test_torch_dp_child.py`` (whose :func:`start` / :func:`finish` launch
it). Jobs import only the port (never jax).
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_dp_child import _init, _np  # noqa: E402


def _t(x):
    import numpy as np
    import torch  # graftlint: disable=GL006

    return torch.from_numpy(np.ascontiguousarray(x))


def job_decode(rank, world, a):
    """Each case of ``a["cases"]`` through ``mp_decode_stride`` or
    ``mp_beam_step`` on an (1 x world) mp grid, from the JAX weights;
    the collectives of each call (``decode_mp.COUNTS``)."""
    import torch  # graftlint: disable=GL006

    from cst_captioning_tpu_torch.config import ModelConfig
    from cst_captioning_tpu_torch.convert import load_flax_params
    from cst_captioning_tpu_torch.models import CaptionModel
    from cst_captioning_tpu_torch.ops import decode_mp
    from cst_captioning_tpu_torch.train import make_mesh

    mesh = make_mesh(mp_devices=world, device="cpu")
    out = {"cell": (mesh.data.rank, mesh.mp.rank)}
    for name, c in a["cases"].items():
        model = load_flax_params(CaptionModel(ModelConfig(**c["model"]),
                                              device="cpu"), c["params"])
        dt = getattr(torch, c["bank"])
        carry = tuple((_t(x), _t(y)) for x, y in c["carry"])
        bank = (_t(c["memory"]).to(dt), _t(c["memory_proj"]).to(dt),
                _t(c["memory_mask"]))
        decode_mp.reset_counts()
        if c["kind"] == "stride":
            _, tok, lp = decode_mp.mp_decode_stride(
                model.cell, carry, _t(c["token"]), _t(c["finished"]), *bank,
                _t(c["noise"]), c["t0"], mesh=mesh, steps=c["steps"],
                temperature=c["temperature"], min_len=c["min_len"])
            out[name] = (tok.numpy(), lp.numpy())
        else:
            _, ts, fl = decode_mp.mp_beam_step(
                model.cell, carry, _t(c["token"]), _t(c["finished"]),
                _t(c["scores"]), *bank, mesh=mesh, t=c["t"],
                min_len=c["min_len"])
            out[name] = (ts.numpy(), fl.numpy())
        out[name + "_counts"] = dict(decode_mp.COUNTS)
    return out


def job_grid(rank, world, a):
    """``make_mesh(mp_devices=2)`` on the world: this rank's cell, its
    column's and row's ranks, and a sum over each group; one XE step of
    the grid (the data column's reduction, the row broadcast) with the
    mp-rank-1 replica's loss perturbed, with and without the row's
    broadcast (``planted``), as parameter lists."""
    import torch  # graftlint: disable=GL006
    import torch.distributed as dist  # graftlint: disable=GL006

    from cst_captioning_tpu_torch.config import ModelConfig, TrainConfig
    from cst_captioning_tpu_torch.convert import load_flax_params
    from cst_captioning_tpu_torch.models import CaptionModel
    from cst_captioning_tpu_torch.parallel import comms
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_mesh, make_optimizer, shard_batch, steps)

    mesh = make_mesh(mp_devices=2, device="cpu")
    out = {"cell": (mesh.data.rank, mesh.mp.rank),
           "axis_names": mesh.axis_names, "shape": mesh.shape,
           "column": mesh.data.global_ranks, "row": mesh.mp.global_ranks}
    sums = []
    for m in (mesh.data, mesh.mp):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=m.group)
        sums.append(float(t))
    out["sums"] = sums
    x = a["xe"]
    feats, masks, labels, mask, weights = (
        {k: _t(v) for k, v in d.items()} if isinstance(d, dict) else _t(d)
        for d in shard_batch(mesh, (x["feats"], x["masks"], x["labels"],
                                    x["mask"], x["weights"])))
    local_sums = steps._local_loss_sums

    def perturbed(*args, **kw):
        num, den = local_sums(*args, **kw)
        return (num * (1 + 1e-3) if mesh.mp.rank == 1 else num), den

    steps._local_loss_sums = perturbed
    for name, row in (("xe", mesh.mp), ("planted", None)):
        model = load_flax_params(CaptionModel(ModelConfig(**x["model"]),
                                              device="cpu"), x["params"])
        state = create_train_state(model, make_optimizer(
            TrainConfig(lr=1e-2, grad_clip=5.0), 10), seed=3)
        comms.reset_row_counts()
        step = steps.make_parallel_xe_step(model, mesh.data, row=row)
        state, m = step(state, feats, masks, labels.long(), mask, weights)
        out[name] = (m["loss"], _np(state.params), dict(comms.ROW_COUNTS))
    steps._local_loss_sums = local_sums
    return out


def main(argv):
    job, rank, world, init_file, args_path, out = argv
    rank, world = int(rank), int(world)
    import torch  # graftlint: disable=GL006

    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        a = pickle.load(f)
    _init(rank, world, init_file)
    result = globals()[f"job_{job}"](rank, world, a)
    with open(f"{out}.rank{rank}", "wb") as f:
        pickle.dump(result, f)
    from cst_captioning_tpu_torch.train import multihost

    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
