"""One rank of a ``('data', 'seq')`` grid of the PyTorch port, for
``tests/test_torch_seq_parallel.py``. Not a test module: it holds no test
functions.

    python tests/test_torch_sp_child.py JOB RANK WORLD INIT_FILE ARGS OUT

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


def _t(tree):
    import numpy as np
    import torch  # graftlint: disable=GL006

    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _sp_inputs(mesh, feats, masks):
    """This rank's rows (data coordinate) and frames (seq coordinate)."""
    from cst_captioning_tpu_torch.parallel.seq_parallel import shard_frames
    from cst_captioning_tpu_torch.train import shard_batch

    feats, masks = shard_batch(mesh, (feats, masks))
    return _t(shard_frames(mesh, feats)), _t(shard_frames(mesh, masks))


def job_sp(rank, world, a):
    """Per encoder, from the JAX weights: the forward, the XE step, the RL
    update at chunks 1 and 3, beam-3, greedy and sampled decodes on the
    grid; the XE step with ``seq_enter``'s backward planted as the
    identity; the long frame axis on a (1 x 2) grid."""
    from cst_captioning_tpu_torch.config import ModelConfig, TrainConfig
    from cst_captioning_tpu_torch.convert import load_flax_params
    from cst_captioning_tpu_torch.decoding import beam_search, greedy_decode
    from cst_captioning_tpu_torch.parallel import seq_parallel as sp
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_mesh, make_optimizer, shard_batch)

    mesh = make_mesh(seq_devices=a["seq"], device="cpu")
    out = {"cell": (mesh.data.rank, mesh.seq.rank),
           "shape": mesh.shape}

    def model_of(enc):
        c = a["cases"][enc]
        return load_flax_params(sp.sp_model(ModelConfig(**c["model"]), mesh,
                                            device="cpu"), c["params"])

    def state_of(model):
        return create_train_state(model, make_optimizer(
            TrainConfig(lr=1e-2, grad_clip=5.0), 10), seed=3)

    for enc, c in a["cases"].items():
        res = out[enc] = {}
        f, m = _sp_inputs(mesh, c["feats"], c["masks"])
        labels, mask, weights = (_t(x) for x in shard_batch(
            mesh, (c["labels"], c["mask"], c["weights"])))
        model = model_of(enc)
        res["logits"] = sp.make_sp_forward(model, mesh)(
            model, f, m, labels.long()).detach().numpy()
        sp.reset_counts()
        step = sp.make_sp_xe_step(model, mesh)
        state, met = step(state_of(model), f, m, labels.long(), mask, weights)
        res["xe"] = (met["loss"], _np(state.params), dict(sp.COUNTS))
        # planted (a): seq_enter's backward as the identity
        model = model_of(enc)
        backward = sp._SeqEnter.backward
        sp._SeqEnter.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            state, met = sp.make_sp_xe_step(model, mesh)(
                state_of(model), f, m, labels.long(), mask, weights)
        finally:
            sp._SeqEnter.backward = backward
        res["xe_planted"] = (met["loss"], _np(state.params))
        samples, adv = (_t(x) for x in shard_batch(
            mesh, (c["samples"], c["adv"]), dim=1))
        valid = _t(shard_batch(mesh, c["valid"]))
        for chunks in (1, 3):
            model = model_of(enc)
            sp.reset_counts()
            upd = sp.make_sp_rl_update(model, mesh, chunks=chunks)
            state, met = upd(state_of(model), f, m, samples.long(), adv,
                             valid)
            res[f"rl{chunks}"] = (met["rl_loss"], _np(state.params),
                                  dict(sp.COUNTS))
        model = model_of(enc)
        res["beam"] = beam_search(model, f, m, beam_size=3,
                                  max_len=c["T"])[0].numpy()
        res["greedy"] = greedy_decode(model, f, m,
                                      max_len=c["T"])[0].numpy()
        for name, fused in (("fused", True), ("two_loop", False)):
            g, s = sp.make_sp_decode(model, mesh, num_rollouts=2,
                                     max_len=c["T"], fused=fused)(
                model, f, m, 7)
            res[f"dec_{name}"] = (g.numpy(), s.numpy())
        g, s = sp.make_sp_decode(model, mesh, max_len=c["T"])(model, f, m, 0)
        res["dec_greedy_only"] = (g.numpy(), s.numpy())
    if "long" in a:
        c = a["long"]
        model = model_of("temporal_attention")
        f, m = _sp_inputs(mesh, c["feats"], c["masks"])
        out["long"] = greedy_decode(model, f, m, max_len=c["T"])[0].numpy()
        out["long_frames"] = f["resnet"].shape[1]
    return out


def _trainer(a, ckpt_dir, log, **extra):
    from cst_captioning_tpu_torch.data import CaptionDataset
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.train.trainer import Trainer

    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=ckpt_dir, **{**a["overrides"], **extra})
    ds = {s: CaptionDataset(a["info_json"], a["features"], s,
                            a["max_frames"]) for s in ("train", "val")}
    return Trainer(cfg, ds["train"], ds["val"], log_path=log, device="cpu",
                   params=a["params"]), ds


def _recording(rollouts):
    """Patch SCSTTrainer._score to record every batch's decoded rows
    (greedy lane first when there is one) -> the original."""
    import numpy as np

    from cst_captioning_tpu_torch.rl import scst as scst_mod

    orig = scst_mod.SCSTTrainer._score

    def recording(self, greedy, samples, *rest, **kw):
        rows = samples.numpy() if greedy is None else np.concatenate(
            [greedy.numpy()[None], samples.numpy()])
        rollouts.append(rows.copy())
        return orig(self, greedy, samples, *rest, **kw)

    scst_mod.SCSTTrainer._score = recording
    return orig


def job_sp_trainer(rank, world, a):
    """The Trainer on a (2 x 2) grid: an XE epoch at dropout 0.5 with
    validation, a CST epoch; an SCST epoch from the start weights; the
    grid evaluator's beam-3 on a wrap-padded batch; the refusals (a batch
    the data axis does not divide, a degraded continuation) and planted
    fault (b), a rank fed another data coordinate's rows."""
    from cst_captioning_tpu_torch.config import EvalConfig
    from cst_captioning_tpu_torch.eval.evaluator import Evaluator
    from cst_captioning_tpu_torch.resilience.health import PeerLost
    from cst_captioning_tpu_torch.rl import scst as scst_mod

    tmp = a["tmp"]
    out = {}
    rollouts = []
    orig = _recording(rollouts)
    try:
        tr, ds = _trainer(a, os.path.join(tmp, "ck"),
                          os.path.join(tmp, "log.jsonl"))
        out["cell"] = (tr.mesh.data.rank, tr.mesh.seq.rank)
        out["local_batch"] = tr.batcher.local_batch_size
        out["val"] = tr.train_xe()
        out["xe_params"] = _np(tr.state.params)
        out["captions"] = tr.validator.evaluate()["captions"]
        tr.train_rl()
        out["rl_params"] = _np(tr.state.params)
        out["cst_rollouts"] = list(rollouts)
        tr.close()
        rollouts.clear()
        tr, _ = _trainer(a, os.path.join(tmp, "ck_scst"),
                         os.path.join(tmp, "scst.jsonl"),
                         rl__baseline="greedy")
        tr.epoch = tr.xe_epochs = 1
        tr.train_rl()
        out["scst_rollouts"] = list(rollouts)
        out["scst_params"] = _np(tr.state.params)
        tr.close()
    finally:
        scst_mod.SCSTTrainer._score = orig
    # the seam of a drained pipelined epoch on the grid: one rank a row
    # gathered, each rank's rows back from it
    import torch  # graftlint: disable=GL006

    scst = scst_mod.SCSTTrainer(tr.model, None, tr.cfg.rl, mesh=tr.mesh)
    d, lb = tr.mesh.data.rank, 2
    rows = torch.arange(d * lb, (d + 1) * lb)
    samples = (rows[None, :, None] * 100 + torch.arange(3)[:, None, None]
               + torch.zeros(1, 1, 5, dtype=torch.long)).int()
    greedy = samples[0] + 7
    vids = [f"v{int(i)}" for i in rows]
    seam = scst._seam_capture((greedy, samples), vids)
    g2, s2 = scst._seam_tokens_to_device(seam, "cpu")
    out["seam"] = (seam["video_ids"], seam["samples"][:, :, 0].tolist(),
                   torch.equal(g2, greedy) and torch.equal(s2, samples),
                   scst._seam_matches(seam, vids))
    # the grid evaluator: beam-3, batch 3 wrap-padded to the data axis
    ev = Evaluator(tr.model, ds["val"], EvalConfig(
        beam_size=3, max_len=a["overrides"]["model__max_len"],
        metrics=("CIDEr-D", "Bleu")), batch_size=3, mesh=tr.mesh)
    res = ev.evaluate(results_json=os.path.join(tmp, f"eval.rank{rank}.json"))
    out["eval"] = (res["captions"], res["metrics"], ev.batcher.batch_size,
                   ev.batcher.local_batch_size, _np(tr.state.params))
    # refusals
    try:
        _trainer(a, os.path.join(tmp, "ck_odd"), "", data__batch_size=3)
    except ValueError as e:
        out["odd_batch"] = str(e)
    tr, _ = _trainer(a, os.path.join(tmp, "ck_deg"), "", train__health=True,
                     train__elastic="degraded",
                     train__health_dir=os.path.join(tmp, "health"))
    try:
        tr._continue_degraded("xe", PeerLost([3], "host 3 lost"))
    except RuntimeError as e:
        out["degraded"] = str(e)
    finally:
        tr.close()
    # planted (b): rank 1 (row 0) collates row 1's rows
    tr, _ = _trainer(a, os.path.join(tmp, "ck_b"), "")
    if rank == 1:
        tr.batcher.host_shard = (1, 2)
    try:
        tr.train_xe()
        out["planted_b"] = None
    except ValueError as e:
        out["planted_b"] = str(e)
    finally:
        tr.close()
    return out


def job_cli(rank, world, a):
    """cli.train (one XE epoch) and then cli.eval on its best checkpoint,
    each with ``mesh.seq_devices`` under RANK / WORLD_SIZE and its own
    --dist-init (each CLI forms and destroys its group)."""
    from cst_captioning_tpu_torch.cli import eval as cli_eval
    from cst_captioning_tpu_torch.cli import train as cli_train

    tr = cli_train.main(a["train"])
    out = {"steps": int(tr.state.step), "rank": tr.rank,
           "cell": (tr.mesh.data.rank, tr.mesh.seq.rank),
           "row": tr.model.encoder.seq.world}
    res = cli_eval.main(a["eval"])
    out.update(metrics=res["metrics"], captions=res["captions"])
    return out


def main(argv):
    job, rank, world, init_file, args_path, out = argv
    rank, world = int(rank), int(world)
    import torch  # graftlint: disable=GL006

    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        a = pickle.load(f)
    if job == "cli":
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    else:
        _init(rank, world, init_file)
    result = globals()[f"job_{job}"](rank, world, a)
    with open(f"{out}.rank{rank}", "wb") as f:
        pickle.dump(result, f)
    from cst_captioning_tpu_torch.train import multihost

    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
