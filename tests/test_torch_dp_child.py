"""One rank of a multi-process run of the PyTorch port, for the
data-parallel tests (``tests/test_torch_mesh.py``, ``test_torch_comms.py``,
``test_torch_multihost.py``, ``test_torch_data_parallel.py``,
``test_torch_rl_split.py``, ``test_torch_elastic.py``). Not a test module:
it holds no test functions.

    python tests/test_torch_dp_child.py JOB RANK WORLD INIT_FILE ARGS OUT

forms a gloo group from ``file://INIT_FILE`` (unless the job's own CLI
does), runs ``JOB(rank, world, args)`` with ``args`` the pickled dict at
ARGS, and pickles the job's result dict to ``OUT.rank<RANK>``. Jobs import
only the port (never jax). :func:`launch` starts the ranks and collects
their results, with a timeout so a hang fails instead of stalling
(:func:`start` and :func:`finish` split it, so that several launches run
at once; ``script=`` launches another module with this command line,
``test_torch_sp_child.py``). A RANK of ``standby<i>`` is a host started
outside the group (a restarted host of an elastic run:
:func:`job_elastic`), its result at ``OUT.standby<i>``.
"""

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(job: str, args: dict, tmp_dir, world: int = 2,
           timeout: float = 120.0, standbys: int = 0
           ) -> tuple[list, list, list]:
    """Run ``job`` on ``world`` gloo ranks, and ``standbys`` processes
    outside the group -> (each process's result dict, or None where one
    wrote none; the exit codes; the stderr texts), the ranks' first. A
    launch past ``timeout`` raises ``subprocess.TimeoutExpired`` after
    killing the processes."""
    return finish(start(job, args, tmp_dir, world, timeout, standbys))


def start(job: str, args: dict, tmp_dir, world: int = 2,
          timeout: float = 120.0, standbys: int = 0,
          script: str = __file__) -> dict:
    """Start :func:`launch`'s processes of ``script`` (a module with this
    one's command line) and return at once; :func:`finish` waits."""
    tmp_dir = str(tmp_dir)
    init = os.path.join(tmp_dir, f"{job}.init")
    args_path = os.path.join(tmp_dir, f"{job}.args")
    out = os.path.join(tmp_dir, f"{job}.out")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    # a rendezvous file or results left by an earlier launch of the job in
    # this directory would pair the ranks with the dead ones
    names = [str(r) for r in range(world)] + [
        f"standby{i}" for i in range(standbys)]
    for stale in [init] + [f"{out}.rank{r}" for r in names]:
        if os.path.exists(stale):
            os.remove(stale)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    # stderr to files: a rank blocked on a full pipe would stall the
    # collective its peer waits in
    err_paths = [f"{out}.rank{r}.err" for r in names]
    procs = []
    try:
        for r, err_path in zip(names, err_paths):
            with open(err_path, "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(script), job, r,
                     str(world), init, args_path, out], env=env,
                    stdout=subprocess.DEVNULL, stderr=err))
    except BaseException:
        _kill(procs)
        raise
    return dict(procs=procs, names=names, out=out, err_paths=err_paths,
                deadline=time.monotonic() + timeout)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish(h: dict) -> tuple[list, list, list]:
    """Wait for a :func:`start`-ed launch -> :func:`launch`'s result."""
    procs = h["procs"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, h["deadline"] - time.monotonic()))
    finally:
        _kill(procs)
    errs = [open(e).read() for e in h["err_paths"]]
    results = []
    for r in h["names"]:
        path = f"{h['out']}.rank{r}"
        results.append(pickle.load(open(path, "rb"))
                       if os.path.exists(path) else None)
    return results, [p.returncode for p in procs], errs


def launch_ok(job: str, args: dict, tmp_dir, world: int = 2,
              timeout: float = 120.0) -> list:
    """:func:`launch`, asserting every rank exited 0."""
    return finish_ok(start(job, args, tmp_dir, world, timeout), job)


def finish_ok(h: dict, job: str = "") -> list:
    """:func:`finish`, asserting every rank exited 0."""
    results, rcs, errs = finish(h)
    if any(rcs):
        raise AssertionError(
            f"job {job} ranks exited {rcs}:\n" +
            "\n".join(e[-3000:] for e in errs))
    return results


# ---- jobs --------------------------------------------------------------------


def _init(rank, world, init_file):
    from cst_captioning_tpu_torch.train import multihost

    multihost.initialize(f"file://{init_file}", world_size=world, rank=rank,
                         backend="gloo", device="cpu", timeout_s=90.0)


def _np(tensors):
    return [t.detach().cpu().numpy().copy() for t in tensors]


def job_comms(rank, world, a):
    """reduce_tree of a parameter-like tree: per leaf, bucketed at several
    targets, bf16 on the wire; a started (async) reduction."""
    import torch  # graftlint: disable=GL006

    from cst_captioning_tpu_torch.parallel.comms import (
        CommConfig, reduce_tree, start_reduce)
    from cst_captioning_tpu_torch.train.mesh import make_mesh, tree_leaves

    mesh = make_mesh(device="cpu")
    leaves, values = tree_leaves(a["trees"][rank])
    grads = [torch.from_numpy(v) for v in values]
    out = {"paths": [lf.path for lf in leaves],
           "none": _np(reduce_tree(grads, mesh, None, leaves)),
           # the JAX test's bf16 case reduces one replicated tree
           "bf16": _np(reduce_tree(
               [torch.from_numpy(v) for v in tree_leaves(a["trees"][0])[1]],
               mesh, CommConfig(dtype="bf16"), leaves)),
           "async": _np(start_reduce(grads, mesh, CommConfig(bucket_mb=0.001),
                                     leaves).wait()),
           "inputs_kept": all(torch.equal(g, torch.from_numpy(v))
                              for g, v in zip(grads, values))}
    for mb in (4.0, 0.001, 0.0):
        out[f"mb{mb}"] = _np(reduce_tree(grads, mesh,
                                         CommConfig(bucket_mb=mb), leaves))
    # replicate: every rank ends with rank 0's parameters, moments and step
    from cst_captioning_tpu_torch.config import TrainConfig
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_optimizer, replicate)

    model = _small_model(a["model_rank"][rank])
    state = create_train_state(model, make_optimizer(TrainConfig(), 1),
                               seed=rank)
    state.step = 3 + rank
    state.opt_state["mu"][0].fill_(float(rank + 1))
    state.opt_state["count"] = 5 + rank
    state = replicate(mesh, state)
    out["replicated"] = (_np(state.params), state.opt_state["mu"][0].numpy(),
                         state.step, state.opt_state["count"], state.seed)
    return out


def job_helpers(rank, world, a):
    """The host-object helpers and their dcn.collective spans."""
    import json

    import numpy as np

    from cst_captioning_tpu_torch import obs
    from cst_captioning_tpu_torch.train import multihost

    obs.configure(os.path.join(a["obs_dir"], f"r{rank}"), run="helpers")
    try:
        out = {
            "host_shard": multihost.host_shard(),
            "is_multiprocess": multihost.is_multiprocess(),
            "pyobj": multihost.allgather_pyobj({"rank": rank,
                                                "ids": [f"v{rank}"] * rank}),
            "bcast": multihost.broadcast_pyobj(
                {"from": rank, "x": 0.1 * (rank + 1)}),
            "wmean": multihost.global_weighted_mean(
                a["sums"][rank], a["weights"][rank]),
            "smean": multihost.global_scalar_mean(float(rank + 1)),
            "gather": multihost.allgather_to_host(
                np.full((2, 3), rank, np.int32), dim=0),
            "gather1": multihost.allgather_to_host(
                np.full((2, 1, 3), rank, np.int32), dim=1),
        }
        multihost.barrier()
    finally:
        obs.shutdown()
    ops = []
    path = os.path.join(a["obs_dir"], f"r{rank}", "events.jsonl")
    for line in open(path):
        rec = json.loads(line)
        if rec.get("name") == "dcn.collective":
            ops.append(rec.get("attrs", {}).get("op") or rec.get("op"))
    out["span_ops"] = ops
    return out


def _small_model(a, device="cpu"):
    from cst_captioning_tpu_torch.config import ModelConfig
    from cst_captioning_tpu_torch.convert import load_flax_params
    from cst_captioning_tpu_torch.models import CaptionModel

    model = CaptionModel(ModelConfig(**a["model"]), device=device)
    return load_flax_params(model, a["params"])


def job_steps(rank, world, a):
    """The data-parallel XE step and RL update (every comm spelling), the
    parallel decodes and the sharded evaluator, from the same weights and
    global inputs as the test's JAX run."""
    import numpy as np
    import torch  # graftlint: disable=GL006

    from cst_captioning_tpu_torch.config import EvalConfig, TrainConfig
    from cst_captioning_tpu_torch.eval.evaluator import Evaluator
    from cst_captioning_tpu_torch.parallel.comms import CommConfig
    from cst_captioning_tpu_torch.rl.scst import (
        make_parallel_rl_decode, make_parallel_rl_update)
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_mesh, make_optimizer, make_parallel_xe_step,
        shard_batch)

    torch.manual_seed(0)
    mesh = make_mesh(device="cpu")
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    out = {}

    def fresh(model, which):
        tx = make_optimizer(TrainConfig(**a[which]), 10)
        return create_train_state(model, tx, seed=1)

    # XE step
    feats, masks, labels, mask, weights = shard_batch(mesh, a["xe"])
    model = _small_model(a)
    step = make_parallel_xe_step(model, mesh, comm=CommConfig())
    state, m = step(fresh(model, "train_xe"),
                    {k: t(v) for k, v in feats.items()},
                    {k: t(v) for k, v in masks.items()}, t(labels).long(),
                    t(mask), t(weights))
    out["xe"] = (m["loss"], _np(state.params))
    # RL updates
    rf, rm = shard_batch(mesh, (a["rl"]["feats"], a["rl"]["masks"]))
    samples, adv = shard_batch(mesh, (a["rl"]["samples"], a["rl"]["adv"]),
                               dim=1)
    valid = shard_batch(mesh, a["rl"]["valid"])
    args = ({k: t(v) for k, v in rf.items()}, {k: t(v) for k, v in rm.items()},
            t(samples).long(), t(adv), t(valid))
    for name, chunks, comm in (
            ("none", 1, None), ("f32", 1, CommConfig()),
            ("bf16", 1, CommConfig(dtype="bf16")),
            ("c2_off", 2, CommConfig()),
            ("c2_eager", 2, CommConfig(overlap="eager")),
            ("c2_defer", 2, CommConfig(overlap="defer"))):
        model = _small_model(a)
        upd = make_parallel_rl_update(model, mesh, chunks=chunks, comm=comm)
        state, m = upd(fresh(model, "train_rl"), *args)
        out[f"rl_{name}"] = (m["rl_loss"], _np(state.params))
    # tests/test_comms.py's bf16 case, on its own model and inputs
    c = a["rl_comms"]
    cf, cm = shard_batch(mesh, (c["feats"], c["masks"]))
    cs, ca = shard_batch(mesh, (c["samples"], c["adv"]), dim=1)
    cargs = ({k: t(v) for k, v in cf.items()}, {k: t(v) for k, v in cm.items()},
             t(cs).long(), t(ca), t(shard_batch(mesh, c["valid"])))
    for name, comm in (("f32", CommConfig()), ("bf16", CommConfig(
            dtype="bf16"))):
        model = _small_model(c)
        upd = make_parallel_rl_update(model, mesh, comm=comm)
        state, m = upd(fresh(model, "train_rl"), *cargs)
        out[f"comms_{name}"] = (m["rl_loss"], _np(state.params))
    # decodes: greedy and sampled rollouts of this rank's rows
    model = _small_model(a)
    df, dm = shard_batch(mesh, (a["dec"]["feats"], a["dec"]["masks"]))
    df = {k: t(v) for k, v in df.items()}
    dm = {k: t(v) for k, v in dm.items()}
    for name, wg, fused in (("fused", True, True), ("two_loop", True, False),
                            ("sample", False, True)):
        dec = make_parallel_rl_decode(model, mesh, a["K"], with_greedy=wg,
                                      fused=fused)
        g, s = dec(model, df, dm, 7)
        out[f"dec_{name}"] = (None if g is None else g.numpy(), s.numpy())
    # the sharded evaluator, on the port's copy of the eval corpus
    from cst_captioning_tpu_torch.data import CaptionDataset

    e = a["eval"]
    ds = CaptionDataset(e["info_json"], e["features"], "test",
                        e["max_frames"])
    emodel = _small_model(e)
    for name, beam, bs in e["cases"]:
        ev = Evaluator(emodel, ds, EvalConfig(beam_size=beam, max_len=8,
                                              metrics=("CIDEr-D", "Bleu")),
                       batch_size=bs, mesh=mesh)
        res = ev.evaluate(results_json=os.path.join(
            e["tmp"], f"{name}.rank{rank}.json"))
        out[f"eval_{name}"] = (res["captions"], res["metrics"],
                               ev.batcher.batch_size,
                               ev.batcher.local_batch_size)
    return out


def _port_trainer(a, rank, ckpt_dir, **extra):
    from cst_captioning_tpu_torch.data import CaptionDataset
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.train.trainer import Trainer

    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=ckpt_dir, **a["overrides"], **extra)

    def ds(split):
        return CaptionDataset(a["info_json"], a["features"], split,
                              a["max_frames"],
                              consensus_weights=cfg.data.consensus_weights)

    return Trainer(cfg, ds("train"), ds("val"),
                   log_path=os.path.join(a["tmp"], "log.jsonl"),
                   device="cpu", params=a.get("params"))


def job_trainer(rank, world, a):
    """A 2-rank XE epoch with validation (and its captions), then a CST
    epoch recording every rank's rollouts; mid-epoch step checkpoints."""
    from cst_captioning_tpu_torch.rl import scst as scst_mod

    rollouts = []
    orig = scst_mod.SCSTTrainer._score

    def recording(self, greedy, samples, *rest, **kw):
        rollouts.append(samples.detach().cpu().numpy().copy())
        return orig(self, greedy, samples, *rest, **kw)

    scst_mod.SCSTTrainer._score = recording
    tr = _port_trainer(a, rank, a["ckpt_dir"], **a.get("extra", {}))
    try:
        val = tr.train_xe()
        xe_params = _np(tr.state.params)
        captions = tr.validator.evaluate()["captions"]
        out = {"val": val, "xe_params": xe_params, "captions": captions,
               "local_batch": tr.batcher.local_batch_size,
               "mesh": (tr.mesh.rank, tr.mesh.world)}
        if a.get("rl"):
            tr.train_rl()
            out.update(rl_params=_np(tr.state.params), rollouts=rollouts)
    finally:
        tr.close()
    return out


def job_resume(rank, world, a):
    """Resume an XE epoch from a mid-epoch step checkpoint (resume=auto)."""
    tr = _port_trainer(a, rank, a["ckpt_dir"], train__resume="auto")
    try:
        tr.train_xe()
        return {"xe_params": _np(tr.state.params)}
    finally:
        tr.close()


def job_cli(rank, world, a):
    """cli.train under RANK / WORLD_SIZE with --dist-init (it forms the
    group itself)."""
    from cst_captioning_tpu_torch.cli.train import main

    tr = main(a["argv"])
    return {"steps": int(tr.state.step), "world": tr.world,
            "rank": tr.rank}


def job_partial_kill(rank, world, a):
    """Rank 1 dies by a seeded chaos kill at xe.step visit 2; rank 0 sleeps
    through the death window on a chaos slow fault, its monitor declares
    rank 1 lost from staleness, and the strict trainer drains before the
    next step's collectives, saves a step checkpoint and raises PeerLost."""
    import glob

    from cst_captioning_tpu_torch.resilience.chaos import (
        Fault, FaultPlan, SimulatedKill)
    from cst_captioning_tpu_torch.resilience.health import PeerLost

    tr = _port_trainer(a, rank, a["ckpt_dir"])
    plan = FaultPlan([Fault("xe.step", "kill", at=2)] if rank == 1 else
                     [Fault("xe.step", "slow", at=2, delay=2.5)])
    out = {"rank": rank}
    try:
        with plan.activate():
            tr.train_xe()
        out["finished"] = True
    except SimulatedKill:
        _write(a, rank, {"rank": rank, "died": "SimulatedKill"})
        os._exit(0)      # a dead host does not clean up
    except PeerLost as e:
        out["peer_lost"] = list(e.hosts)
        out["drained_ckpts"] = sorted(
            os.path.basename(p)
            for p in glob.glob(os.path.join(a["ckpt_dir"], "step_*")))
        out["step"] = int(tr.state.step)
    _write(a, rank, out)
    os._exit(0)          # the lost peer never joins a teardown


class TokenReward:
    """``tests/test_async_scst.py``'s rigged reward: +1 per occurrence of
    a target token; ``calls`` keeps every scored row batch."""

    def __init__(self, target: int = 7):
        self.target = target
        self.calls = []

    def __call__(self, video_ids, rows):
        import numpy as np

        rows = np.asarray(rows)
        self.calls.append(rows.copy())
        return (rows == self.target).sum(axis=1).astype(np.float32)


def split_run(a, case, mesh, device="cpu"):
    """One decoupled epoch of ``case`` (``rl`` overrides, ``faults``,
    ``stop_after``) on ``mesh`` (a real or a virtual DataMesh) from the
    test's weights and batches -> its ledgers, events, scored rows,
    losses, params and drained ring."""
    import torch  # graftlint: disable=GL006

    from cst_captioning_tpu_torch.config import RLConfig, TrainConfig
    from cst_captioning_tpu_torch.resilience.chaos import Fault, FaultPlan
    from cst_captioning_tpu_torch.rl import AsyncSCSTTrainer, rollout_seed
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_optimizer)

    model = _small_model(a, device)
    tx = make_optimizer(TrainConfig(**a["train"]), 10)
    state = create_train_state(model, tx, seed=1)
    events = []
    reward = TokenReward()
    tr = AsyncSCSTTrainer(
        model, reward, RLConfig(**{**a["rl"], **case.get("rl", {})}),
        batch_size=a["B"], mesh=mesh,
        on_event=lambda e, **kw: events.append([e, kw]))
    t = lambda x: {k: torch.from_numpy(v).to(device)  # noqa: E731
                   for k, v in x.items()}
    batches = [(t(f), t(m), list(v), None) for f, m, v in a["batches"]]
    from cst_captioning_tpu_torch.train import multihost

    faults = [Fault("rl.actor.step", k, at=at, host=h)
              for k, at, h in case.get("faults", ())]
    me = multihost.process_index()
    plan = FaultPlan(faults if me in case.get("ranks", (me,)) else [])
    seen = {"n": 0}

    def stop():
        seen["n"] += 1
        return seen["n"] > case.get("stop_after", 10 ** 9)

    sink = {}
    with plan.activate():
        state, ms = tr.train_epoch(
            state, batches, lambda j: rollout_seed(7, 0, 1, j),
            should_stop=stop, seam_sink=sink)
    return {"staleness": dict(tr.last_staleness),
            "dropped": tr.last_dropped, "rejoined": tr.last_rejoined,
            "events": events, "fired": [f["kind"] for f in plan.fired],
            "calls": reward.calls, "losses": [m["rl_loss"] for m in ms],
            "rewards": [m["reward_mean"] for m in ms],
            "params": _np(state.params), "step": int(state.step),
            "n_actors": tr._plan.n_actors if tr._plan else 1,
            "fallback": tr._fallback_sync, "occupancy": tr.last_occupancy,
            "stopped": tr.last_stopped, "ring": sink.get("ring", [])}


def job_split(rank, world, a):
    """Each case of ``a["cases"]`` through ``split_run`` on the world's
    ranks."""
    from cst_captioning_tpu_torch.train.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    return {c["name"]: split_run(a, c, mesh) for c in a["cases"]}


def job_split_trainer(rank, world, a):
    """The decoupled topology through the Trainer on the world's ranks:
    for each case of ``a["cases"]`` a Trainer from the seeded init (XE
    skipped), its RL epoch under the case's fault plan on every rank
    (``ranks``: on those alone); ``resume`` restarts the case named there
    from its checkpoints with ``train.resume="auto"``."""
    import json

    from cst_captioning_tpu_torch.data import CaptionDataset
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.resilience.chaos import Fault, FaultPlan
    from cst_captioning_tpu_torch.resilience.preempt import Preempted
    from cst_captioning_tpu_torch.train.trainer import Trainer

    out = {}
    for case in a["cases"]:
        name = case["name"]
        run_dir = os.path.join(a["tmp"], case.get("resume", name))
        extra = {"train__resume": "auto"} if case.get("resume") else {}
        cfg = get_experiment(a["preset"]).override(
            train__ckpt_dir=os.path.join(run_dir, "ck"), **a["overrides"],
            **extra)
        ds = CaptionDataset(a["info_json"], a["features"], "train",
                            a["max_frames"],
                            consensus_weights=cfg.data.consensus_weights)
        log = os.path.join(a["tmp"], f"{name}.jsonl")
        tr = Trainer(cfg, ds, None, log_path=log, device="cpu")
        if not case.get("resume"):
            tr.epoch = tr.xe_epochs = 1      # as after the XE epoch
        faults = [Fault(*f) for f in case.get("faults", ())]
        plan = FaultPlan(faults if rank in case.get("ranks", (rank,))
                         else [])
        res = {"preempted": False}
        try:
            with plan.activate():
                tr.train_rl()
        except Preempted:
            res["preempted"] = True
        finally:
            tr.close()
        mine = log if rank == 0 else log.replace(".jsonl",
                                                 f".proc{rank}.jsonl")
        res.update(params=_np(tr.state.params), step=int(tr.state.step),
                   rl_epochs=tr.rl_epochs,
                   fired=[f["kind"] for f in plan.fired],
                   events=[json.loads(x) for x in open(mine)])
        out[name] = res
    return out


def state_digest(state) -> str:
    """sha256 of a TrainState's parameters, Adam moments and step: equal
    digests are bitwise equal states."""
    import hashlib

    h = hashlib.sha256()
    tensors = list(state.params)
    for k in sorted(state.opt_state):
        v = state.opt_state[k]
        if isinstance(v, list):
            tensors.extend(v)
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    h.update(str(int(state.step)).encode())
    return h.hexdigest()


def tap_steps(digests: dict):
    """Record ``(state_digest, world)`` after every XE step and RL update
    the trainer module builds, keyed ``"<phase>:<step>"`` -> the undo."""
    from cst_captioning_tpu_torch.rl import scst as scst_mod
    from cst_captioning_tpu_torch.train import trainer as trainer_mod

    saved = (trainer_mod.make_parallel_xe_step, trainer_mod.make_xe_step,
             scst_mod.SCSTTrainer._apply)

    def wrap(factory, parallel):
        def make(*args, **kw):
            step = factory(*args, **kw)
            world = args[1].world if parallel else 1

            def tapped(state, *rest):
                state, m = step(state, *rest)
                digests[f"xe:{int(state.step)}"] = (state_digest(state),
                                                    world)
                return state, m
            return tapped
        return make

    def apply(self, state, *rest):
        state, m = saved[2](self, state, *rest)
        digests[f"rl:{int(state.step)}"] = (
            state_digest(state), 1 if self.mesh is None else self.mesh.world)
        return state, m

    trainer_mod.make_parallel_xe_step = wrap(saved[0], True)
    trainer_mod.make_xe_step = wrap(saved[1], False)
    scst_mod.SCSTTrainer._apply = apply

    def undo():
        (trainer_mod.make_parallel_xe_step, trainer_mod.make_xe_step,
         scst_mod.SCSTTrainer._apply) = saved
    return undo


def _exit_at_allreduce(n: int):
    """This process dies inside its ``n``-th all-reduce (0-based): the
    peer is then inside the same collective."""
    import torch.distributed as dist  # graftlint: disable=GL006

    real, seen = dist.all_reduce, {"n": 0}

    def all_reduce(t, *args, **kw):
        if seen["n"] == n:
            os._exit(0)
        seen["n"] += 1
        return real(t, *args, **kw)

    dist.all_reduce = all_reduce


def job_elastic(rank, world, a):
    """One host of an elastic run for ``tests/test_torch_elastic.py``: the
    Trainer under the run's config (health on, ``elastic="degraded"``),
    its XE and RL phases, every step's state digest (:func:`tap_steps`).
    ``a["hosts"][rank]`` plans this host: ``faults`` (chaos
    ``(point, kind, at)``; a ``kill`` exits the process without cleanup)
    and ``exit_allreduce`` (die inside that all-reduce). A standby
    (``rank`` ``"standby<i>"``, ``a["standbys"][i]``) is host ``host``
    restarted: it waits for its tombstone, then starts the Trainer, which
    rejoins; ``flaky`` exits after the announce, before the rendezvous."""
    import json
    import shutil
    import time

    from cst_captioning_tpu_torch import obs
    from cst_captioning_tpu_torch.data import CaptionDataset
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.resilience import health
    from cst_captioning_tpu_torch.resilience.chaos import (
        Fault, FaultPlan, SimulatedKill)
    from cst_captioning_tpu_torch.train import multihost
    from cst_captioning_tpu_torch.train.trainer import Trainer

    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=a["ckpt_dir"], **a["overrides"])
    ds = CaptionDataset(a["info_json"], a["features"], "train",
                        a["max_frames"])
    drains: list = []
    restore = Trainer._restore_drain

    def keep(self, what):
        # a copy of each drain save the run continues from (a later save
        # of the same step number would replace it), for its reference
        out = restore(self, what)
        infos = out[1]
        if self.rank == 0:
            dst = os.path.join(a["tmp"], "drains",
                               f"h{self.host_id}_{len(drains)}")
            shutil.copytree(os.path.join(a["ckpt_dir"],
                                         self._last_step_ckpt),
                            os.path.join(dst, self._last_step_ckpt))
            drains.append({"what": what, "dir": dst,
                           "name": self._last_step_ckpt,
                           "key": f"{infos['phase']}:{infos['global_step']}",
                           "generation": self._degraded_gen})
        return out

    Trainer._restore_drain = keep
    poll = Trainer._poll_rejoin

    def slow_poll(self):
        # the degraded stretch lasts long enough for a restarted host
        if self.health is not None and self.health.lost_hosts:
            time.sleep(a.get("degraded_boundary_s", 0.0))
        poll(self)

    Trainer._poll_rejoin = slow_poll
    standby = a.get("_standby")
    if standby is not None:
        spec = a["standbys"][standby]
        host, plan_spec = spec["host"], spec
        tomb = os.path.join(a["health_dir"], f"host{host}.dead")
        deadline = time.monotonic() + a.get("standby_wait", 60.0)
        while not os.path.exists(tomb):
            if time.monotonic() > deadline:
                return {"host": host, "standby": standby, "never": True}
            time.sleep(0.02)
        multihost.set_identity(host, world, "gloo", timeout_s=90.0)
        if spec.get("flaky"):
            def gone(*args, **kw):
                _write(a, f"standby{standby}",
                       {"host": host, "standby": standby, "flaky": True})
                os._exit(0)
            health.rendezvous = gone
        log = os.path.join(a["tmp"], f"log_s{standby}.jsonl")
    else:
        host, plan_spec = rank, a["hosts"].get(rank, {})
        log = os.path.join(a["tmp"], "log.jsonl")
        if plan_spec.get("exit_allreduce") is not None:
            _exit_at_allreduce(plan_spec["exit_allreduce"])
    digests: dict = {}
    tap_steps(digests)
    tr = Trainer(cfg, ds, None, log_path=log, device="cpu")
    if standby is None:
        # every monitor has seen every peer beat before a host dies (a
        # peer never seen is lost by tombstone only)
        deadline = time.monotonic() + 30.0
        while any(tr.health._seen_seq.get(p) is None
                  for p in tr.health.peers):
            assert time.monotonic() < deadline, "a peer never beat"
            time.sleep(0.02)
        multihost.barrier()
    plan = FaultPlan([Fault(p, k, at=at, **kw)
                      for p, k, at, kw in plan_spec.get("faults", ())])
    out = {"host": host, "standby": standby, "rejoined": tr.rejoined}
    try:
        with plan.activate():
            tr.train_xe()
            tr.train_rl()
    except SimulatedKill:
        # what the test reads of a dead host: its steps and drain saves
        mine = log if host == 0 else log.replace(".jsonl",
                                                 f".proc{host}.jsonl")
        _write(a, rank, {"host": host, "died": "SimulatedKill",
                         "digests": digests, "drains": drains,
                         "events": [json.loads(x) for x in open(mine)]})
        os._exit(0)      # a dead host does not clean up
    finally:
        tr.close()
        obs.shutdown()
    mine = log if host == 0 else log.replace(".jsonl", f".proc{host}.jsonl")
    out.update(digests=digests, params=_np(tr.state.params),
               step=int(tr.state.step), rl_epochs=tr.rl_epochs,
               xe_epochs=tr.xe_epochs, rank=tr.rank, world=tr.world,
               survivors=tr.health.survivors(),
               generation=tr.health.generation,
               fired=[f["kind"] for f in plan.fired], drains=drains,
               events=[json.loads(x) for x in open(mine)])
    return out


def job_elastic_ref(rank, world, a):
    """The reference of a continuation: the run's config on this world
    (no health), resumed from ``a["resume"]`` (a directory holding one
    drain save), to the end of the run, every step's digest recorded."""
    from cst_captioning_tpu_torch.data import CaptionDataset
    from cst_captioning_tpu_torch.presets import get_experiment
    from cst_captioning_tpu_torch.train.trainer import Trainer

    digests: dict = {}
    tap_steps(digests)
    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=a["ckpt_dir"], train__resume=a["resume"],
        **{**a["overrides"], **a.get("ref_overrides", {})})
    ds = CaptionDataset(a["info_json"], a["features"], "train",
                        a["max_frames"])
    tr = Trainer(cfg, ds, None, device="cpu", use_mesh=True)
    try:
        tr.train_xe()
        tr.train_rl()
    finally:
        tr.close()
    return {"digests": digests, "params": _np(tr.state.params),
            "step": int(tr.state.step)}


def _write(a, rank, payload):
    with open(f"{a['_out']}.rank{rank}", "wb") as f:
        pickle.dump(payload, f)


def main(argv):
    job, rank, world, init_file, args_path, out = argv
    world = int(world)
    import torch  # graftlint: disable=GL006

    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        a = pickle.load(f)
    a["_out"] = out
    if rank.startswith("standby"):
        # a host started outside the group: the job forms its own
        a["_standby"] = int(rank[len("standby"):])
    else:
        rank = int(rank)
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
