"""Elastic training in the port (``train/trainer.py``'s degraded-mesh
continuation and grow-back, ``train/multihost.py``'s ``regroup``):

- one process with two simulated hosts, through both packages (the JAX
  trainer at ``num_devices=1`` with ``use_mesh=True``, the port's at a
  world-1 ``DataMesh``): an XE loss and rejoin, with the params after the
  phase within the port's JAX-trainer tolerance, then the three RL
  scenarios of ``tests/test_chaos_train.py:452-636`` (a loss mid-epoch, a
  loss then a rejoin, a flaky rejoiner), each from the end of that XE
  phase. Equal: the drain, shrink, regrow and refusal events' JAX fields,
  the fired faults, ``health.generation``, the survivors and the
  ``rl_step`` clock. The port's RL draws differ from the JAX trainer's by
  design (``rl/scst.py``), so its RL params are held to the JAX tests'
  own pins through the port: the regrown trainer and a fresh one resumed
  from the same save run an epoch bitwise alike, and the flaky run ends
  bitwise equal to the run with no rejoin;
- two gloo ranks (``test_torch_dp_child.job_elastic``): host 1 killed by a
  chaos kill at ``xe.step`` and at ``rl.step`` (sequential), and by an
  exit inside an all-reduce (pipelined: the drain applies no pending
  update); each survivor's ``degraded_mesh`` fields equal the JAX
  trainer's one-process two-device run (the pipelined one's resumed batch
  is the first unapplied, by the real-rank drain rule); a restarted host 1
  rejoins (world 2 again); host 0, rank 0, killed mid pipelined epoch, so
  host 1 writes the drain save; a restarted host 0 that exits before the
  rendezvous is refused. Every stretch between two membership changes is
  bitwise equal, step by step (params, Adam moments, step), to a fresh run
  at that world resumed from the drain save it started from;
- the fleet merge of that run's bundles names the victim and renders the
  shrink -> regrow arc.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from cst_captioning_tpu.data import CaptionDataset as JaxDataset
from cst_captioning_tpu.data import make_synthetic_dataset as jax_synthetic
from cst_captioning_tpu.resilience import Fault as JaxFault
from cst_captioning_tpu.resilience import FaultPlan as JaxFaultPlan
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    RLConfig,
    TrainConfig,
)
from cst_captioning_tpu_torch.convert import state_dict_to_flax
from cst_captioning_tpu_torch.data import CaptionDataset, make_synthetic_dataset
from cst_captioning_tpu_torch.obs import fleet
from cst_captioning_tpu_torch.resilience import Fault, FaultPlan
from cst_captioning_tpu_torch.train.trainer import Trainer
from test_torch_dp_child import launch, tap_steps

torch.set_num_threads(1)

TOL = 1e-5          # the port's XE trainer against the JAX trainer
ELASTIC_EVENTS = ("peer_loss_drain", "degraded_mesh", "regrow_drain",
                  "mesh_regrow", "regrow_refused")
CORPUS = dict(num_videos=12, num_topics=3, vocab_words=20,
              modalities={"resnet": 16}, max_frames=4, seed=5)


def events_of(path, kind):
    return [e for e in map(json.loads, open(path)) if e["event"] == kind]


def elastic_fields(path) -> dict:
    """Each elastic event's fields as the JAX trainer logs them (no
    timestamp; a refusal's free-text detail names the timeout)."""
    return {k: [{f: v for f, v in e.items() if f not in ("ts", "detail")}
                for e in events_of(path, k)] for k in ELASTIC_EVENTS}


def make_cfg(ckpt_dir, vocab_size, **train_kw) -> ExperimentConfig:
    """tests/test_chaos_train.py's elastic config (two simulated hosts,
    batch 2, pipelined) at one device."""
    train_kw.setdefault("eval_every_epochs", 100)
    train_kw.setdefault("epochs", 1)
    return ExperimentConfig(
        name="chaos",
        model=ModelConfig(vocab_size=vocab_size, modalities=(("resnet", 16),),
                          d_embed=16, d_hidden=16, d_att=8,
                          encoder="temporal_attention", dropout=0.0,
                          max_len=8, max_frames=4, dtype="float32"),
        data=DataConfig(batch_size=2, seq_per_vid=1),
        train=TrainConfig(lr=5e-3, grad_clip=5.0, ckpt_dir=str(ckpt_dir),
                          seed=0, log_every_steps=1, health=True,
                          health_sim_hosts=2, elastic="degraded",
                          **train_kw),
        rl=RLConfig(enabled=True, num_rollouts=2, lr=1e-3, epochs=2,
                    baseline="greedy", pipelined=True),
        eval=EvalConfig(beam_size=1, max_len=8),
        mesh=MeshConfig(num_devices=1))


# ---- one process, simulated hosts, both packages -------------------------------

# the XE phase: host 1 lost after step 2 of 5, back at the next boundary
XE_FAULTS = [("xe.step", "partial_preempt", 1), ("health.rejoin",
                                                 "host_rejoin", 0)]
# tests/test_chaos_train.py's three RL scenarios
RL_SCENARIOS = {
    "degraded": ([("rl.step", "partial_preempt", 6)], {}),
    "regrow": ([("rl.step", "partial_preempt", 0),
                ("health.rejoin", "host_rejoin", 0)], {}),
    "flaky": ([("rl.step", "partial_preempt", 0),
               ("health.rejoin", "host_rejoin_flaky", 0)],
              {"peer_timeout_s": 0.2}),
    "plain": ([("rl.step", "partial_preempt", 0)], {"peer_timeout_s": 0.2}),
}


def _run(pkg, root, ds, faults, rl: bool, params=None, **train_kw):
    """One package's Trainer under ``faults`` (``(point, kind, at)``,
    host 1) -> (trainer, its log, the fired kinds, its initial params).
    ``rl``: resume the XE phase's end (``root/xe_end``) and run the RL
    phase; else the XE phase (the port from ``params``, the JAX
    trainer's initial ones)."""
    os.makedirs(root, exist_ok=True)
    kw = dict(train_kw, resume=os.path.join(os.path.dirname(root),
                                            "xe_end")) if rl else train_kw
    cfg = make_cfg(root, len(ds.vocab), **kw)
    log = os.path.join(root, "ev.jsonl")
    if pkg == "jax":
        tr = JaxTrainer(JaxExperimentConfig.from_json(cfg.to_json()), ds,
                        None, log_path=log, use_mesh=True)
        params = jax.tree.map(np.asarray, jax.device_get(tr.state.params))
        ch = (JaxFault, JaxFaultPlan)
    else:
        tr = Trainer(cfg, ds, None, log_path=log, device="cpu",
                     use_mesh=True, params=params)
        ch = (Fault, FaultPlan)
    plan = ch[1]([ch[0](p, k, at=at, host=1) for p, k, at in faults])
    try:
        with plan.activate():
            if rl:
                tr.train_rl()
            else:
                tr.train_xe()
    finally:
        tr.close()
    return tr, log, [f["kind"] for f in plan.fired], params


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """Both packages' runs: the XE scenario (its end kept for the RL
    scenarios), then each RL scenario from it."""
    root = tmp_path_factory.mktemp("elastic_sim")
    port_paths = make_synthetic_dataset(str(root / "pdata"), **CORPUS)
    jax_paths = jax_synthetic(str(root / "jdata"), **CORPUS)
    dss = {"port": CaptionDataset(port_paths["info_json"],
                                  {"resnet": port_paths["resnet"]}, "train",
                                  4),
           "jax": JaxDataset(jax_paths["info_json"],
                             {"resnet": jax_paths["resnet"]}, "train", 4)}
    out = {}
    init = None
    for pkg in ("jax", "port"):
        ds, base = dss[pkg], root / pkg
        *run, init = _run(pkg, str(base / "xe"), ds, XE_FAULTS, False,
                          params=init)
        # the XE phase's epoch-end save, alone, for the RL scenarios
        os.makedirs(base / "xe_end")
        os.rename(base / "xe" / "latest", base / "xe_end" / "latest")
        out[pkg, "xe"] = run
        for name, (faults, kw) in RL_SCENARIOS.items():
            if pkg == "jax" and name == "plain":
                continue     # the port's own no-rejoin reference
            out[pkg, name] = _run(pkg, str(base / name), ds, faults, True,
                                  **kw)[:3]
    out["dss"] = dss
    return out


@pytest.mark.parametrize("scenario", ["xe", "degraded", "regrow", "flaky"])
def test_simulated_hosts_match_the_jax_trainer(sim, scenario):
    ptr, plog, pfired = sim["port", scenario]
    jtr, jlog, jfired = sim["jax", scenario]
    assert pfired == jfired
    assert elastic_fields(plog) == elastic_fields(jlog)
    assert ptr.health.generation == jtr.health.generation
    assert ptr.health.survivors() == jtr.health.survivors()
    assert ptr.mesh.world == jtr.mesh.devices.size == 1
    for kind in ("xe_step", "rl_step"):
        assert [e["step"] for e in events_of(plog, kind)] == \
            [e["step"] for e in events_of(jlog, kind)]
    got = elastic_fields(plog)
    if scenario == "xe":
        assert got["degraded_mesh"][0]["resumed_batch_index"] == 2
        assert got["mesh_regrow"][0]["generation"] == 2
        # the XE trainers agree within the port's JAX-trainer tolerance
        jp = jax.device_get(jtr.state.params)
        pp = state_dict_to_flax(ptr.model.cfg, ptr.model.state_dict())
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            want = np.asarray(leaf)
            node = pp
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(np.asarray(node), want, rtol=TOL,
                                       atol=TOL, err_msg=str(path))
    elif scenario == "degraded":
        (deg,) = got["degraded_mesh"]
        assert deg["lost"] == [1] and deg["survivors"] == [0]
        assert 0 < deg["resumed_batch_index"] < 5
        assert ptr.rl_epochs == 2
    elif scenario == "regrow":
        assert [e["generation"] for e in got["mesh_regrow"]] == [2]
        assert sorted({e["step"] for e in events_of(plog, "rl_step")}) == \
            list(range(1, 11))
    else:
        (ref,) = got["regrow_refused"]
        assert ref["rejoiner"] == 1 and not got["mesh_regrow"]


def test_flaky_rejoin_leaves_the_port_run_bitwise_unharmed(sim):
    plain, flaky = sim["port", "plain"][0], sim["port", "flaky"][0]
    assert elastic_fields(sim["port", "flaky"][1])["regrow_drain"]
    assert int(plain.state.step) == int(flaky.state.step)
    for a, b in zip(plain.state.params, flaky.state.params):
        assert torch.equal(a, b)


def test_regrown_program_equals_a_fresh_resume(sim, tmp_path):
    """The JAX test's program-identity pin through the port: a fresh
    trainer without the monitor, resumed from the regrown run's last
    save, runs one more epoch bitwise alike with the regrown one (params
    and Adam moments)."""
    tr = sim["port", "regrow"][0]
    ds = sim["dss"]["port"]
    cfg2 = dataclasses.replace(
        tr.cfg, train=dataclasses.replace(tr.cfg.train, health=False,
                                          resume="auto"))
    tr2 = Trainer(cfg2, ds, None, device="cpu", use_mesh=True)
    assert tr2.epoch == tr.epoch and tr2.state.step == tr.state.step
    tr.train_rl(epochs=1)
    tr2.train_rl(epochs=1)
    tr2.close()
    for a, b in zip(tr.state.params, tr2.state.params):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(tr.state.opt_state[k], tr2.state.opt_state[k]):
            assert torch.equal(a, b)


# ---- two gloo ranks --------------------------------------------------------------


MODEL = dict(modalities=(("resnet", 12),), d_embed=16, d_hidden=16, d_att=8,
             encoder="temporal_attention", dropout=0.0, max_len=8,
             max_frames=4, dtype="float32")


@pytest.fixture(scope="module")
def ranks_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_ranks_data")
    paths = make_synthetic_dataset(
        str(root), num_videos=16, num_topics=3, vocab_words=20,
        modalities={"resnet": 12}, max_frames=4, seed=9)
    vocab = len(json.load(open(paths["info_json"]))["vocab"])
    return paths, vocab


def _rank_args(corpus, tmp, pipelined: bool, **extra) -> dict:
    paths, vocab = corpus
    ov = {f"model__{k}": v for k, v in MODEL.items()}
    ov.update(model__vocab_size=vocab, data__batch_size=4,
              data__seq_per_vid=2, mesh__num_devices=2, train__lr=5e-3,
              train__epochs=2, train__eval_every_epochs=100, train__seed=0,
              train__keep_ckpts=50, train__log_every_steps=1,
              train__health=True, train__health_dir=os.path.join(tmp,
                                                                 "health"),
              train__health_interval_s=0.1, train__peer_timeout_s=0.5,
              train__health_misses=2, train__elastic="degraded",
              rl__epochs=2, rl__num_rollouts=2, rl__pipelined=pipelined)
    ov.update(extra.pop("overrides", {}))
    return {"preset": "msrvtt_cst_consensus", "overrides": ov,
            "info_json": paths["info_json"],
            "features": {"resnet": paths["resnet"]}, "max_frames": 4,
            "tmp": tmp, "ckpt_dir": os.path.join(tmp, "ck"),
            "health_dir": os.path.join(tmp, "health"), **extra}


def _reference(a, drain, world, tmp_path):
    """A fresh run at ``world`` resumed from the drain save ``drain`` to
    the end (no monitor) -> its step digests. One rank runs here; two run
    as gloo ranks."""
    ref_ov = {"train__health": False, "mesh__num_devices": world}
    ck = os.path.join(str(tmp_path), f"ref_{os.path.basename(drain['dir'])}")
    if world > 1:
        (r0, r1) = _launch_ok("elastic_ref", {
            **a, "resume": drain["dir"], "ckpt_dir": ck,
            "ref_overrides": ref_ov}, ck)
        assert r0["digests"] == r1["digests"]
        return r0["digests"]
    from cst_captioning_tpu_torch.presets import get_experiment

    digests: dict = {}
    undo = tap_steps(digests)
    try:
        cfg = get_experiment(a["preset"]).override(
            train__ckpt_dir=ck, train__resume=drain["dir"],
            **{**a["overrides"], **ref_ov})
        ds = CaptionDataset(a["info_json"], a["features"], "train", 4)
        tr = Trainer(cfg, ds, None, device="cpu", use_mesh=True)
        try:
            tr.train_xe()
            tr.train_rl()
        finally:
            tr.close()
    finally:
        undo()
    return digests


def _launch_ok(job, a, tmp, world=2, standbys=0):
    os.makedirs(tmp, exist_ok=True)
    res, rcs, errs = launch(job, a, tmp, world=world, timeout=120,
                            standbys=standbys)
    assert not any(rcs), "\n".join(e[-3000:] for e in errs)
    return res


def _stretch(digests: dict, world: int, after: str, until: str | None):
    """The digests of one host taken at ``world`` on the steps after the
    drain ``after`` (``"<phase>:<step>"``) and up to ``until``."""
    order = {"xe": 0, "rl": 1}

    def key(k):
        ph, st = k.split(":")
        return order[ph], int(st)

    lo = key(after)
    hi = key(until) if until else (9, 0)
    return {k: v for k, v in digests.items()
            if lo < key(k) <= hi and v[1] == world}


@pytest.fixture(scope="module")
def lifecycle(ranks_corpus, tmp_path_factory):
    """Two ranks, pipelined RL, obs on: host 1 killed after XE step 4; a
    restarted host 1 rejoins; host 0 (rank 0) killed after the second RL
    update; a restarted host 0 that exits before the rendezvous."""
    tmp = str(tmp_path_factory.mktemp("elastic_lifecycle"))
    a = _rank_args(
        ranks_corpus, tmp, True,
        overrides={"train__obs": True,
                   "train__obs_dir": os.path.join(tmp, "obs"),
                   "train__recorder_steps": 16},
        hosts={0: {"faults": [("rl.step", "kill", 1, {})]},
               1: {"faults": [("xe.step", "kill", 3, {})]}},
        standbys=[{"host": 1}, {"host": 0, "flaky": True}],
        degraded_boundary_s=0.25)
    res = _launch_ok("elastic", a, tmp, standbys=2)
    return a, res, tmp


def test_lifecycle_on_real_ranks(lifecycle):
    a, (h0, h1, s1, s0), tmp = lifecycle
    assert h1["died"] == h0["died"] == "SimulatedKill"
    assert s0 == {"host": 0, "standby": 1, "flaky": True}
    ev = {k: [e for e in s1["events"] if e["event"] == k]
          for k in ELASTIC_EVENTS + ("rejoined",)}
    # the rejoiner joined generation 2 at world 2, then lost host 0 and
    # refused its flaky return; it finished the run alone
    (joined,) = ev["rejoined"]
    assert joined["generation"] == 2 and joined["hosts"] == [0, 1]
    assert joined["rank"] == 1 and joined["world"] == 2
    (drain,) = ev["peer_loss_drain"]
    assert drain["phase"] == "rl" and drain["lost"] == [0]
    (deg,) = ev["degraded_mesh"]
    assert deg["lost"] == [0] and deg["survivors"] == [1]
    assert deg["devices"] == 1
    (refused,) = ev["regrow_refused"]
    assert refused["rejoiner"] == 0 and refused["generation"] == 4
    assert s1["rl_epochs"] == 2 and s1["world"] == 1 and s1["rank"] == 0
    assert s1["generation"] == 3 and s1["survivors"] == [1]
    # the lowest live host (host 1, not rank 0) wrote the drain save, and
    # the drain applied no update past the loss and saved no seam
    save = [e for e in s1["events"] if e["event"] == "ckpt_step"
            and e["step"] == drain["step"]][-1]
    assert save["seam"] is False and "bytes" in save
    assert drain["batch_index"] == drain["step"] == 2
    # host 0 saw the shrink and the regrow before it died
    assert [d["what"] for d in h0["drains"]] == [
        "degraded continuation", "regrow continuation"]
    assert [d["what"] for d in s1["drains"]] == [
        "degraded continuation", "regrow continuation"]


def test_each_stretch_is_bitwise_a_fresh_resume(lifecycle, tmp_path):
    """Shrink (world 1 from host 0's XE drain), regrow (world 2 from the
    regrow drain, on both hosts), shrink with rank 0 the victim (world 1
    from host 1's drain, through the refused flaky rejoin to the end):
    each stretch equals, step by step, a fresh run at its world resumed
    from the drain save it began at."""
    a, (h0, h1, s1, s0), tmp = lifecycle
    stretches = [
        (1, h0["drains"][0], [h0]),
        (2, h0["drains"][1], [h0, s1]),
        (1, s1["drains"][0], [s1]),
    ]
    for world, drain, hosts in stretches:
        ref = _reference(a, drain, world, tmp_path)
        for run in hosts:
            got = _stretch(run["digests"], world, drain["key"], None)
            assert got, (world, drain)
            assert {k: v[0] for k, v in got.items()} == \
                {k: ref[k][0] for k in got}, (world, drain)


def test_fleet_merge_names_the_victim_and_renders_the_arc(lifecycle):
    a, _, tmp = lifecycle
    merged = fleet.merge_bundles(os.path.join(tmp, "obs"))
    assert merged["merged_procs"] == [0, 1]
    assert merged["victim_hosts"] == [0]
    (arc,) = [x for x in merged["elastic"] if x["host"] == 1]
    assert arc["outcome"] == "readmitted" and arc["regrow_gen"] == 2
    text = fleet.render_fleet(merged)
    assert "victim host(s): [0]" in text
    assert "elastic: host 1 shrink" in text and "--> regrow" in text


# the rl.step visit the sequential kill fires at: after the second update
# (3 batches of 4 an epoch: mid-epoch 1)
RL_KILL_AT = 1
# the all-reduce the pipelined victim exits inside: 2 an XE step (the
# loss sums, one gradient bucket) over 12 XE steps, then 2 an RL update:
# the gradient all-reduce of the third update
EXIT_ALLREDUCE = 24 + 2 * 2 + 1
DEGRADED_FIELDS = ("phase", "lost", "survivors", "devices", "global_batch",
                   "resumed_phase", "resumed_batch_index")


@pytest.fixture(scope="module")
def jax_two_device(ranks_corpus, tmp_path_factory):
    """The JAX trainer's one-process run on two devices with two
    simulated hosts, on the ranks' corpus and config: host 1 lost after
    XE step 4 and back at the next boundary, then lost at the sequential
    RL kill's visit -> its two degraded_mesh events."""
    root = tmp_path_factory.mktemp("elastic_jax2")
    paths, _ = ranks_corpus
    jp = jax_synthetic(str(root / "data"), num_videos=16, num_topics=3,
                       vocab_words=20, modalities={"resnet": 12},
                       max_frames=4, seed=9)
    a = _rank_args(ranks_corpus, str(root), False)
    from cst_captioning_tpu_torch.presets import get_experiment

    # The planned faults decide this run's events (both losses are the
    # partial_preempt faults, host 1's readmission is the host_rejoin
    # fault), so staleness must never decide one. A simulated host beats
    # only once, at its rejoin: if the watchdog reads that beat while
    # readmit is between its membership update and the beat file's
    # removal, a stall past peer_timeout_s declares host 1 lost by
    # heartbeat timeout, and the planned rl.step kill then finds no peer.
    # Its rendezvous never wait (survivor markers are written by the run
    # itself), so a timeout no stall reaches changes nothing else.
    ov = {**a["overrides"], "train__health_sim_hosts": 2,
          "train__peer_timeout_s": 60.0,
          "train__ckpt_dir": str(root / "ck")}
    cfg = get_experiment(a["preset"]).override(**ov)
    ds = JaxDataset(jp["info_json"], {"resnet": jp["resnet"]}, "train", 4)
    log = str(root / "ev.jsonl")
    tr = JaxTrainer(JaxExperimentConfig.from_json(cfg.to_json()), ds, None,
                    log_path=log)
    plan = JaxFaultPlan([
        JaxFault("xe.step", "partial_preempt", at=3, host=1),
        JaxFault("health.rejoin", "host_rejoin", at=0, host=1),
        JaxFault("rl.step", "partial_preempt", at=RL_KILL_AT, host=1)])
    try:
        assert tr.mesh.devices.size == 2
        with plan.activate():
            tr.train_xe()
            tr.train_rl()
    finally:
        tr.close()
    return [{k: e[k] for k in DEGRADED_FIELDS}
            for e in events_of(log, "degraded_mesh")]


@pytest.mark.parametrize("case", ["rl_step_sequential",
                                  "allreduce_pipelined"])
def test_survivor_continues_bitwise(ranks_corpus, jax_two_device,
                                    tmp_path, case):
    """Host 1 dies mid-RL: by a chaos kill after an update (sequential),
    or inside the gradient all-reduce of an update (pipelined: the
    survivor's collective raises, its monitor confirms the loss, and the
    drain applies neither that update nor the pending one). The survivor
    continues at world 1, bitwise equal to a fresh one-rank resume from
    its drain save; its shrink event equals the JAX trainer's."""
    tmp = str(tmp_path)
    pipelined = case == "allreduce_pipelined"
    victim = ({"exit_allreduce": EXIT_ALLREDUCE} if pipelined
              else {"faults": [("rl.step", "kill", RL_KILL_AT, {})]})
    a = _rank_args(ranks_corpus, tmp, pipelined, hosts={1: victim})
    h0, h1 = _launch_ok("elastic", a, tmp)
    assert h1 is None or h1["died"] == "SimulatedKill"
    ev = {k: [e for e in h0["events"] if e["event"] == k]
          for k in ELASTIC_EVENTS + ("collective_peer_loss",)}
    (drain,) = ev["peer_loss_drain"]
    (deg,) = ev["degraded_mesh"]
    want = jax_two_device[1]
    if pipelined:
        # the update in flight and the pending one are not applied: the
        # save is at the first unapplied batch, with no seam
        (raised,) = ev["collective_peer_loss"]
        assert raised["lost"] == [1] and raised["phase"] == "rl"
        assert drain["batch_index"] == drain["step"] == 2
        want = dict(want, resumed_batch_index=2)
        save = [e for e in h0["events"] if e["event"] == "ckpt_step"][-1]
        assert save["seam"] is False
    assert {k: deg[k] for k in DEGRADED_FIELDS} == want
    assert h0["world"] == 1 and h0["rl_epochs"] == 2
    (d,) = h0["drains"]
    ref = _reference(a, d, 1, tmp_path)
    got = _stretch(h0["digests"], 1, d["key"], None)
    assert len(got) >= 3
    assert {k: v[0] for k, v in got.items()} == {k: ref[k][0] for k in got}


def test_xe_kill_shrink_equals_the_jax_trainer(lifecycle, jax_two_device):
    """The lifecycle run's XE loss (host 1 killed after step 4) on the
    survivor, against the JAX trainer's two-device run."""
    _, (h0, *_), _ = lifecycle
    (deg,) = [e for e in h0["events"] if e["event"] == "degraded_mesh"]
    assert {k: deg[k] for k in DEGRADED_FIELDS} == jax_two_device[0]
