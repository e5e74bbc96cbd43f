"""The serving lifecycle of the port (cst_captioning_tpu_torch.serving) on
the CPU, held against the JAX package on the same seeded inputs.

The JAX CaptionService runs at decode_impl="pallas" (the stride kernel in
Pallas interpret mode) and the port's service takes the JAX service's own
Gumbel draws through ``noise_fn``. Tolerances: tokens, versions and lanes
exact; logprobs within 2e-5 (float32, the serving slice's TOL). Covered:
the mid-flight hot swap with version-pinned lanes and the publish rules;
drain snapshots written by either package and replayed by the other onto
a grown service; SIGTERM and request_drain; grow_capacity with live lane
state; the SLO monitor; grouped admission (tokens equal to solo admission,
logprobs within 8 float32 ulps: a batched encoder GEMM is not bit-equal to
a solo one, on either package); static_batch_serve; the peer-loss drain
(each package's active health monitor loses host 1 from the feedback:
both engines drain with reason "peer_loss" at the same stride, and each
replay completes the undrained serve).
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, ModelConfig
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.serving import CaptionService as JaxCaptionService
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu.serving import load_snapshot as jax_load_snapshot
from cst_captioning_tpu.serving import static_batch_serve as jax_static_serve
from cst_captioning_tpu.resilience import health as jax_health
from cst_captioning_tpu.serving.engine import SloMonitor as JaxSloMonitor
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.resilience import health as port_health
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    PageBank,
    SloMonitor,
    load_snapshot,
    request_drain,
    static_batch_serve,
)

torch.set_num_threads(1)

MODAL = (("resnet", 16),)
T = 12
MAX_F = 8
V = 97
TOL = 2e-5
ULPS = 8 * 2.0 ** -23   # grouped vs solo admission, relative
KW = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16, d_att=8,
          encoder="temporal_attention", dropout=0.0, max_len=T,
          max_frames=MAX_F, dtype="float32", decode_impl="pallas",
          decode_stride=4)
SNAPSHOT_KEYS = {"requests", "page_table", "in_flight_steps", "staged",
                 "drain_reason"}


def _tmodel(params, **overrides):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**{**KW, **overrides}),
                          device="cpu"),
        jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def setup():
    jmodel = CaptionModel(ModelConfig(**KW))
    rng = np.random.default_rng(0)
    params = jmodel.init(
        jax.random.key(0),
        {"resnet": jnp.asarray(rng.normal(size=(1, MAX_F, 16)), jnp.float32)},
        {"resnet": jnp.ones((1, MAX_F), jnp.float32)},
        jnp.zeros((1, T), jnp.int32),
    )
    # EOS-biased so caption lengths vary (the continuous-batching regime)
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    # a second version whose captions differ: one output logit raised
    p2 = jax.tree.map(lambda x: x, params)
    p2["params"]["cell"]["out_proj"]["bias"] = (
        params["params"]["cell"]["out_proj"]["bias"].at[5].add(3.0))
    return dict(jmodel=jmodel, params=params, p2=p2,
                tmodel=_tmodel(params), tmodel2=_tmodel(p2))


def _requests(frames=(1, 8, 3, 8, 2, 5), seed0=1000, cls=ClipRequest,
              prefix="r"):
    out = []
    for i, F in enumerate(frames):
        rng = np.random.default_rng(100 + i)
        out.append(cls(
            req_id=f"{prefix}{i}",
            feats={"resnet": rng.normal(size=(F, 16)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)},
            seed=seed0 + i,
        ))
    return out


@jax.jit
def _jax_row_noise(seed, ts):
    """The JAX service's per-request draws: gumbel(fold_in(fold_in(
    key(seed), k), t), (1, V)) for local steps ts [S] -> [S, K, V]."""
    key = jax.random.key(seed)
    ks = jax.vmap(lambda k: jax.random.fold_in(key, k))(jnp.arange(2))

    def step(t):
        ks_t = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(ks)
        return gumbel_step_noise(ks_t, (1, V), jnp.float32)[:, 0]

    return jax.vmap(step)(ts)


def jax_noise(seeds, ts, K, v):
    assert K == 2 and v == V
    rows = [np.asarray(_jax_row_noise(jnp.int32(s), jnp.asarray(ts[:, b],
                                                                jnp.int32)))
            for b, s in enumerate(seeds.tolist())]
    return torch.from_numpy(np.stack(rows, axis=2))


def _service(tmodel, **kw):
    base = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2,
                device="cpu", noise_fn=jax_noise)
    return CaptionService(tmodel, **{**base, **kw})


def _jax_service(s, capacity=2, **kw):
    return JaxCaptionService(s["jmodel"], s["params"], capacity=capacity,
                             num_rollouts=2, stride=4, frame_bucket=2, **kw)


def _assert_match(got, want, rids=None):
    for rid in rids or want:
        g, w = got[rid], want[rid]
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=rid)
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=TOL,
                                   atol=TOL, err_msg=rid)
        assert g.best_lane == w.best_lane and g.caption_ids == w.caption_ids


def _drain_after(svc, n, how):
    """feedback: ``how(svc)`` once the n-th completion is recorded."""
    seen = []

    def feedback(req, result, version):
        seen.append(req.req_id)
        if len(seen) == n:
            how(svc)

    svc._feedback = feedback
    return seen


# ---- hot parameter swaps ----------------------------------------------------


def test_hot_swap_midflight_matches_jax(setup):
    """A publish from the first completion's feedback lands at the next
    stride boundary on both packages: the same requests pin each version,
    mixed-version strides run one launch per live version with the other
    version's lanes frozen, and every lane matches the JAX service."""
    s = setup
    jsvc = _jax_service(s)
    jpub = []

    def jfeedback(req, result, version):
        if not jpub:
            jpub.append(jsvc.publish_params(s["p2"], version=1))

    jsvc._feedback = jfeedback
    jrep = jsvc.serve(_requests(cls=JaxClipRequest))

    pub = []
    svc = _service(s["tmodel"])

    def feedback(req, result, version):
        if not pub:
            pub.append(svc.publish_params(s["tmodel2"], version=1))

    svc._feedback = feedback
    launches = []
    run_stride = svc._run_stride

    def counted(report, now):
        launches.append(len({t.param_version
                             for t in svc._inflight.values()}))
        run_stride(report, now)

    svc._run_stride = counted
    rep = svc.serve(_requests())
    assert pub == jpub == [True]
    assert rep.completed == 6 and not rep.drained
    versions = {r: res.param_version for r, res in rep.results.items()}
    assert versions == {r: res.param_version
                        for r, res in jrep.results.items()}
    assert set(versions.values()) == {0, 1}
    assert max(launches) == 2          # a stride with both versions live
    _assert_match(rep.results, jrep.results)
    assert svc.param_version == 1 and len(svc._swap_history) == 1
    assert svc._old_versions == {} and jsvc._old_params == {}
    assert svc.slo_snapshot() is None
    # a replayed or stale publish is refused
    assert not svc.publish_params(s["tmodel"], version=1)
    assert svc.param_version == 1 and svc._pending_publish is None
    # version 1 really decodes differently (the pins are not vacuous)
    alone = [_service(m).serve(_requests(frames=(8,) * 3, seed0=1))
             for m in (s["tmodel"], s["tmodel2"])]
    assert any(not np.array_equal(alone[0].results[r].tokens,
                                  alone[1].results[r].tokens)
               for r in alone[0].results)


def test_publish_rules(setup):
    s = setup
    svc = _service(s["tmodel"])
    assert svc.publish_params(s["tmodel2"].state_dict(), version=3)
    assert not svc.publish_params(s["tmodel2"], version=3)   # duplicate
    assert not svc.publish_params(s["tmodel2"], version=2)   # stale
    assert svc.publish_params(s["tmodel2"])                  # 4 supersedes
    assert svc._pending_publish[0] == 4 and svc.param_version == 0
    rep = svc.serve(_requests(frames=(2, 5)))
    assert svc.param_version == 4
    assert {r.param_version for r in rep.results.values()} == {4}
    # the published copy holds the new weights; the caller's model is not
    # shared
    assert svc.model is not s["tmodel2"]
    assert torch.equal(svc.model.cell.out_proj.bias,
                       s["tmodel2"].cell.out_proj.bias)
    svc.drain("test")
    assert not svc.publish_params(s["tmodel"], version=9)
    # a publish pending when a drain lands is dropped at the boundary
    svc2 = _service(s["tmodel"])
    assert svc2.publish_params(s["tmodel2"], version=1)
    svc2.drain("test")
    rep2 = svc2.serve(_requests(frames=(2,)))
    assert rep2.drained and svc2.param_version == 0
    with pytest.raises(RuntimeError, match="state_dict"):
        _service(s["tmodel"]).publish_params({"no_such": torch.zeros(1)})


# ---- drain, snapshots and replay ---------------------------------------------


def _snapshot_requests(reqs):
    return [(r.req_id, r.seed, r.arrival_s,
             {m: (np.asarray(r.feats[m]), np.asarray(r.masks[m]))
              for m in r.feats}) for r in reqs]


def _assert_same_requests(a, b):
    a, b = _snapshot_requests(a), _snapshot_requests(b)
    assert [x[:3] for x in a] == [x[:3] for x in b]
    for x, y in zip(a, b):
        for m in x[3]:
            np.testing.assert_array_equal(x[3][m][0], y[3][m][0])
            np.testing.assert_array_equal(x[3][m][1], y[3][m][1])


def test_jax_snapshot_replays_on_grown_port_service(setup, tmp_path):
    """A queue the JAX service drained replays through the port's
    load_snapshot onto a capacity-2 service grown to 4; drained plus
    replayed results equal the undrained JAX serve."""
    s = setup
    base = _jax_service(s, capacity=4).serve(_requests(cls=JaxClipRequest))
    snap = str(tmp_path / "jax_drain")
    jsvc = _jax_service(s, capacity=4)
    _drain_after(jsvc, 2, lambda svc: svc.drain("test"))
    drained = jsvc.serve(_requests(cls=JaxClipRequest), snapshot_dir=snap)
    assert drained.drained and 0 < drained.completed < 6

    svc = _service(s["tmodel"])
    pages = svc.bank.num_pages
    restored = load_snapshot(snap, service=svc, grow_to=4)
    _assert_same_requests(restored, jax_load_snapshot(snap))
    assert svc.B == 4 and len(svc._free_slots) == 4
    assert svc.bank.num_pages == pages + 2 * svc.table_width
    replay = svc.serve()
    assert set(replay.results) | set(drained.results) == set(base.results)
    _assert_match(replay.results, base.results, list(replay.results))


def test_port_snapshot_replays_in_jax(setup, tmp_path):
    """The port's snapshot has the JAX layout (manifest keys, in-flight
    requests first, array names); the JAX load_snapshot reads the same
    requests, and the JAX service's replay plus the port's drained results
    equal the undrained JAX serve."""
    s = setup
    base = _jax_service(s).serve(_requests(cls=JaxClipRequest))
    snap = str(tmp_path / "port_drain")
    svc = _service(s["tmodel"])
    run_stride = svc._run_stride

    def drain_at_fourth(report, now):
        run_stride(report, now)
        if report.strides == 4:
            svc.drain("test")

    svc._run_stride = drain_at_fourth
    drained = svc.serve(_requests(), snapshot_dir=snap)
    assert drained.drained and drained.drain_reason == "test"
    assert drained.snapshot_dir == snap
    manifest = json.load(open(os.path.join(snap, "manifest.json")))
    assert set(manifest) == SNAPSHOT_KEYS
    assert manifest["page_table"]["num_pages"] == svc.bank.num_pages
    # in flight (admitted first), staged, then queued
    assert manifest["in_flight_steps"] == {"r2": 4, "r3": 4}
    assert manifest["staged"] == ["r4"]
    assert [r["req_id"] for r in manifest["requests"]] == [
        "r2", "r3", "r4", "r5"]
    with np.load(os.path.join(snap, "queue.npz")) as z:
        assert sorted(z.files) == sorted(
            f"{i}.{k}.resnet" for i in range(len(manifest["requests"]))
            for k in ("feats", "masks"))
    # the working set was released
    assert svc.bank.pages_in_use == 0 and not svc._inflight
    assert len(svc._free_slots) == 2
    jreqs = jax_load_snapshot(snap)
    _assert_same_requests(load_snapshot(snap), jreqs)
    assert len(jreqs) == 6 - drained.completed
    replay = _jax_service(s).serve(jreqs)
    _assert_match(drained.results, base.results, list(drained.results))
    _assert_match(replay.results, base.results, list(replay.results))
    assert set(replay.results) | set(drained.results) == set(base.results)


def test_sigterm_and_request_drain(setup, tmp_path):
    """SIGTERM reaches the loop through PreemptionHandler (reason
    "sigterm") and request_drain through the serving service; both stop at
    the stride boundary after the trigger, where the JAX service stops on
    the same trigger."""
    s = setup
    reqs = dict(frames=(8,) * 6, seed0=6000)

    def sigterm(_svc):
        os.kill(os.getpid(), signal.SIGTERM)

    jsvc = _jax_service(s, capacity=1)
    _drain_after(jsvc, 1, sigterm)
    jrep = jsvc.serve(_requests(cls=JaxClipRequest, **reqs),
                      snapshot_dir=str(tmp_path / "jsig"))
    prev = signal.getsignal(signal.SIGTERM)
    svc = _service(s["tmodel"], capacity=1)
    _drain_after(svc, 1, sigterm)
    snap = str(tmp_path / "sig")
    rep = svc.serve(_requests(**reqs), snapshot_dir=snap)
    assert signal.getsignal(signal.SIGTERM) == prev   # handler uninstalled
    assert rep.drained and rep.drain_reason == jrep.drain_reason == "sigterm"
    assert set(rep.results) == set(jrep.results) and rep.completed < 6
    assert len(load_snapshot(snap)) == 6 - rep.completed

    svc2 = _service(s["tmodel"], capacity=1)
    _drain_after(svc2, 2, lambda _svc: request_drain("ops"))
    rep2 = svc2.serve(_requests(**reqs), snapshot_dir=str(tmp_path / "ops"))
    assert rep2.drained and rep2.drain_reason == "ops"
    assert rep2.completed == 2
    with pytest.raises(RuntimeError, match="no CaptionService"):
        request_drain()


def test_peer_loss_drain_matches_jax(setup, tmp_path):
    """A peer lost mid-serve (the active monitor's simulate_loss from the
    feedback after the 2nd completion): both engines drain with reason
    "peer_loss" at the same stride with the same completed requests; each
    package's replay of its snapshot completes the undrained serve."""
    s = setup
    out = {}
    for name, health, make, cls, load in (
            ("jax", jax_health, lambda: _jax_service(s), JaxClipRequest,
             jax_load_snapshot),
            ("port", port_health, lambda: _service(s["tmodel"]), ClipRequest,
             load_snapshot)):
        base = make().serve(_requests(cls=cls))
        mon = health.HealthMonitor(str(tmp_path / f"{name}_hb"), host_id=0,
                                   num_hosts=2, start_thread=False).start()
        try:
            svc = make()
            _drain_after(svc, 2, lambda _svc: mon.simulate_loss(1))
            snap = str(tmp_path / f"{name}_snap")
            drained = svc.serve(_requests(cls=cls), snapshot_dir=snap)
        finally:
            mon.stop()
        assert drained.drained and drained.drain_reason == "peer_loss"
        assert drained.snapshot_dir == snap and 2 <= drained.completed < 6
        replay = make().serve(load(snap))
        union = {**drained.results, **replay.results}
        assert set(union) == set(base.results)
        _assert_match(union, base.results)
        out[name] = (drained, replay, base)
    (jd, jr, jb), (td, tr, tb) = out["jax"], out["port"]
    assert td.strides == jd.strides and set(td.results) == set(jd.results)
    assert set(tr.results) == set(jr.results)
    _assert_match(tb.results, jb.results)
    # the drain read the flag: with no monitor the same serve runs through
    assert port_health.active_monitor() is None
    assert not _service(s["tmodel"]).serve(_requests()).drained


# ---- grow_capacity -----------------------------------------------------------


def test_grow_capacity_with_live_state_matches_jax(setup):
    s = setup
    first = dict(frames=(1, 8, 3), seed0=1000)
    second = dict(frames=(8, 2, 5, 4), seed0=2000, prefix="g")
    jsvc = _jax_service(s)
    jsvc.serve(_requests(cls=JaxClipRequest, **first))
    jsvc.grow_capacity(4)
    jrep = jsvc.serve(_requests(cls=JaxClipRequest, **second))

    svc = _service(s["tmodel"])
    svc.serve(_requests(**first))
    assert svc._lanes is not None
    pages, width = svc.bank.num_pages, svc.table_width
    svc.grow_capacity(4)
    assert svc.B == 4 and sorted(svc._free_slots) == [0, 1, 2, 3]
    assert svc.bank.num_pages == pages + 2 * width
    assert svc.bank.mem.shape[0] == svc.bank.num_pages + 1
    assert tuple(svc.bank.row_table.shape) == (4, width)
    lanes = svc._lanes
    assert all(c.shape[1] == 4 and h.shape[1] == 4 for c, h in lanes.carry)
    assert bool(lanes.finished[:, 2:].all())
    assert (lanes.token[:, 2:] == 1).all() and (lanes.seeds[2:] == 0).all()
    rep = svc.serve(_requests(**second))
    _assert_match(rep.results, jrep.results)
    with pytest.raises(ValueError, match="only grows"):
        svc.grow_capacity(2)


def test_page_bank_grows():
    bank = PageBank(num_pages=3, page_size=4)
    assert bank.can_fit(12) and not bank.can_fit(13)
    pages = bank.alloc("a", 9)
    assert bank.length("a") == 9 and bank.length("b") == 0
    bank.init_rows(1, 3)
    bank.bind_row(0, "a")
    mem = torch.arange(9 * 2, dtype=torch.float32).reshape(1, 9, 2)
    bank.store(pages, mem, mem[..., :1], torch.ones(1, 9))
    bank.grow(5)
    assert bank.num_pages == 5 and bank.free_pages == 2
    assert bank.mem.shape == (6, 4, 2) and bank.mask.shape == (6, 4)
    assert float(bank.mem[4:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        bank.mem[pages].reshape(12, 2)[:9].numpy(), mem[0].numpy())
    assert bank.alloc("b", 8) == [4, 5]
    bank.grow_rows(3)
    assert bank.row_table.tolist() == [pages, [0, 0, 0], [0, 0, 0]]
    assert bank.row_lens.tolist() == [9, 0, 0]
    with pytest.raises(ValueError, match="only grows"):
        bank.grow(4)
    with pytest.raises(ValueError, match="only grow"):
        bank.grow_rows(2)


# ---- the SLO monitor -----------------------------------------------------------


def test_slo_monitor_matches_jax():
    """One fake-clock latency sequence through both monitors: equal burn
    rates after every completion, the same alerts (edge-triggered, a new
    excursion re-alerts) and breaches, and window expiry."""
    from cst_captioning_tpu.obs import metrics as obs_metrics

    obs_metrics.REGISTRY.reset()
    kw = dict(objective=0.9, windows=(10.0, 100.0), fast_burn=2.0,
              slow_burn=1.5)
    jmon, mon = JaxSloMonitor(0.1, **kw), SloMonitor(0.1, **kw)
    seq = ([0.05] * 9 + [0.5] + [0.5] * 6 + [0.01] * 24 + [0.5] * 12)
    alerts = []
    for i, lat in enumerate(seq):
        jmon.observe(lat, now=float(i))
        mon.observe(lat, now=float(i))
        for w in (10.0, 100.0):
            assert mon.burn[w] == pytest.approx(jmon.burn_rate(w, float(i)),
                                                abs=1e-12)
        alerts.append(mon.alerts)
        assert mon.alerts == jmon.alerts
    assert alerts[9] == 0 and alerts[15] == 1 and alerts[-1] == 2
    snap = obs_metrics.snapshot()
    assert mon.breaches == snap["counters"]["serving.slo.breaches"] == 19
    for w in (10, 100):
        assert mon.attainment[float(w)] == pytest.approx(
            snap["gauges"][f"serving.slo.attainment.{w}s"])
    assert mon.burn_rate(10.0, now=260.0) == jmon.burn_rate(10.0, 260.0) == 0.0
    assert mon.burn_rate(100.0, now=260.0) == 0.0


@pytest.mark.parametrize("args", [
    dict(target_s=0.0),
    dict(target_s=0.1, objective=1.0),
    dict(target_s=0.1, windows=(600.0, 60.0)),
])
def test_slo_monitor_validation_matches_jax(args):
    with pytest.raises(ValueError) as want:
        JaxSloMonitor(**args)
    with pytest.raises(ValueError) as got:
        SloMonitor(**args)
    assert str(got.value) == str(want.value)


def test_service_slo_snapshot_matches_jax(setup):
    """set_slo arms the monitor; served completions fill it; slo_snapshot
    equals the JAX service's on the same serve; target <= 0 disarms."""
    s = setup
    jsvc = _jax_service(s)
    svc = _service(s["tmodel"])
    assert svc.slo_snapshot() is None
    for x in (jsvc, svc):
        x.set_slo(30.0)
    jsvc.serve(_requests(frames=(2, 8, 5), cls=JaxClipRequest))
    svc.serve(_requests(frames=(2, 8, 5)))
    snap = svc.slo_snapshot()
    assert snap == jsvc.slo_snapshot()
    assert snap["burn_rate"] == {"60s": 0.0, "600s": 0.0}
    assert svc._slo.attainment == {60.0: 1.0, 600.0: 1.0}
    slow = _service(s["tmodel"], slo_target_s=1e-9, slo_objective=0.5,
                    slo_fast_burn=1.0, slo_slow_burn=1.0)
    slow.serve(_requests(frames=(2, 8)))
    assert slow._slo.alerts == 1 and slow._slo.breaches == 2
    # the windows and the snapshot read one clock: every request breached
    assert slow.slo_snapshot()["burn_rate"] == {"60s": 2.0, "600s": 2.0}
    svc.set_slo(0.0)
    assert svc.slo_snapshot() is None


# ---- grouped admission ----------------------------------------------------------


def _count_encodes(svc):
    """The requests of each encoder pass of ``svc``."""
    calls = []
    encode = svc._encode_batch

    def counted(reqs, F):
        calls.append(len(reqs))
        return encode(reqs, F)

    svc._encode_batch = counted
    return calls


@pytest.mark.parametrize("capacity,frames,num_pages", [
    (4, (8, 8, 8, 8), None),
    # two lanes, one bucket, a pool for six: the rest is staged in a group
    (2, (8, 7, 8, 8, 7, 8), 24),
])
def test_grouped_admission_matches_solo(setup, capacity, frames, num_pages):
    """admit_group=4 encodes each frame bucket's admissible requests in one
    pass (staging too, unpadded); tokens equal solo admission, logprobs
    within 8 ulps; against the JAX grouped service within TOL."""
    s = setup
    reqs = dict(frames=frames, seed0=5000)
    kw = dict(capacity=capacity, num_pages=num_pages)
    solo = _service(s["tmodel"], **kw)
    svc = _service(s["tmodel"], admit_group=4, **kw)
    assert svc.admit_group == svc.requested_admit_group == 4
    n_solo, n_group = _count_encodes(solo), _count_encodes(svc)
    want = solo.serve(_requests(**reqs))
    got = svc.serve(_requests(**reqs))
    assert n_solo == [1] * len(frames)
    assert n_group == ([4] if capacity == 4 else [2, 4])
    for rid, w in want.results.items():
        np.testing.assert_array_equal(got.results[rid].tokens, w.tokens)
        np.testing.assert_allclose(got.results[rid].logprobs, w.logprobs,
                                   rtol=ULPS, atol=ULPS)
    jrep = _jax_service(s, admit_group=4, **kw).serve(
        _requests(cls=JaxClipRequest, **reqs))
    _assert_match(got.results, jrep.results)


def test_bf16_admission_group_falls_back(setup):
    s = setup
    svc = _service(_tmodel(s["params"], dtype="bfloat16"), capacity=4,
                   admit_group=4)
    jsvc = JaxCaptionService(
        CaptionModel(ModelConfig(**{**KW, "dtype": "bfloat16"})),
        s["params"], capacity=4, num_rollouts=2, admit_group=4)
    assert (svc.requested_admit_group, svc.admit_group) == (4, 1)
    assert (jsvc.requested_admit_group, jsvc.admit_group) == (4, 1)
    calls = _count_encodes(svc)
    rep = svc.serve(_requests(frames=(8, 8, 8, 8), seed0=5000))
    assert rep.completed == 4 and calls == [1, 1, 1, 1]


# ---- static batching -------------------------------------------------------------


def test_static_batch_serve_matches_jax(setup):
    """Fixed-shape batches of 4 (the last padded with its first row),
    every lane equal to the JAX policy's with the JAX batch draws fed in;
    without noise_fn the batch seed decides the draws."""
    s = setup
    jrep = jax_static_serve(s["jmodel"], s["params"],
                            _requests(cls=JaxClipRequest), capacity=4,
                            num_rollouts=2, service_seed=3)
    shapes = []

    def noise_fn(batch):
        rng = jax.random.fold_in(jax.random.key(3), batch)
        keys = rollout_step_keys(rng, 2, T)

        def draw(t):
            n = torch.from_numpy(np.array(
                gumbel_step_noise(keys[t], (4, V), jnp.float32)))
            shapes.append(tuple(n.shape))
            return n

        return draw

    rep = static_batch_serve(s["tmodel"], _requests(), capacity=4,
                             num_rollouts=2, noise_fn=noise_fn, device="cpu")
    assert rep.completed == jrep.completed == 6
    assert set(shapes) == {(2, 4, V)}
    for res in rep.results.values():
        assert res.tokens.shape == (3, T) and res.param_version == 0
    _assert_match(rep.results, jrep.results)
    a, b = (static_batch_serve(s["tmodel"], _requests(), capacity=4,
                               service_seed=seed, device="cpu")
            for seed in (0, 0))
    for rid, res in a.results.items():
        np.testing.assert_array_equal(res.tokens, b.results[rid].tokens)
        np.testing.assert_array_equal(res.tokens[0],
                                      rep.results[rid].tokens[0])
