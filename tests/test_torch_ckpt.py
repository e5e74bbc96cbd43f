"""The port's checkpoints on the CPU: its own format round-trips exactly,
the best/latest policy, the fallback from a corrupt ``latest``, ``step_*``
rotation, the pure-Python msgpack decoder against
``flax.serialization.msgpack_restore`` on a JAX TrainState's bytes, and a
checkpoint the JAX ``CheckpointManager`` wrote loaded into the port
(params, Adam moments, count, step), from which one XE step matches the
JAX step within 1e-5 (dropout 0)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from flax import serialization

from cst_captioning_tpu.ckpt import CheckpointManager as JaxManager
from cst_captioning_tpu.config.config import ModelConfig, TrainConfig
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import create_train_state
from cst_captioning_tpu.train.steps import make_xe_step
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.ckpt import (
    CheckpointManager,
    CorruptCheckpointError,
    load_params,
    load_state,
    save_state,
)
from cst_captioning_tpu_torch.ckpt import msgpack
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    random_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel

torch.set_num_threads(1)

TOL = 1e-5
B, F, T, V = 4, 3, 6, 23
MODAL = (("resnet", 8), ("c3d", 5))
KW = dict(vocab_size=V, modalities=MODAL, d_embed=8, d_hidden=8, d_att=4,
          encoder="temporal_attention", dropout=0.0, max_len=T, max_frames=F,
          dtype="float32")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    masks = {n: (np.arange(F)[None] < np.array([[1], [3], [2], [3]])
                 ).astype(np.float32) for n, _ in MODAL}
    mask = (np.arange(T)[None] < np.array([[2], [6], [4], [3]])
            ).astype(np.float32)
    labels = np.where(mask > 0, rng.integers(4, V, size=(B, T)), 0
                      ).astype(np.int32)
    return feats, masks, labels, mask, np.ones((B,), np.float32)


def _tbatch(b):
    feats, masks, labels, mask, w = b
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return ({k: t(v) for k, v in feats.items()},
            {k: t(v) for k, v in masks.items()}, t(labels).long(), t(mask),
            t(w))


def _port_state(seed=0, stepped=2):
    cfg = tcfg.ModelConfig(**KW)
    model = load_flax_params(TorchCaptionModel(cfg, device="cpu"),
                             random_flax_params(cfg, seed))
    tx = ttrain.make_optimizer(tcfg.TrainConfig(lr=1e-2), 10)
    state = ttrain.create_train_state(model, tx, seed=7)
    step = ttrain.make_xe_step(model)
    for i in range(stepped):
        state, _ = step(state, *_tbatch(_batch(i)))
    return state


def _equal_states(a, b):
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)
    assert set(a.opt_state) == set(b.opt_state)
    assert a.opt_state["count"] == b.opt_state["count"]
    for key in ("mu", "nu"):
        for x, y in zip(a.opt_state[key], b.opt_state[key]):
            assert torch.equal(x, y)
    assert a.step == b.step and a.seed == b.seed


def test_save_load_round_trips_exactly(tmp_path):
    state = _port_state()
    path = save_state(str(tmp_path), "latest", state, {"epoch": 3},
                      extra_files={"seam.npz": b"x"})
    assert sorted(os.listdir(path)) == ["infos.json", "manifest.json",
                                        "seam.npz", "state.npz"]
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        assert "params/cell/out_proj/kernel" in z.files
        assert "opt_state/mu/cell/attention/score/kernel" in z.files
        assert int(z["step"]) == 2 and int(z["opt_state/count"]) == 2
    fresh = _port_state(seed=1, stepped=0)
    got, infos = load_state(str(tmp_path), "latest", fresh)
    assert got is fresh and infos == {"epoch": 3}
    _equal_states(got, state)
    # params only (the handoff), into a model with other weights
    other = _port_state(seed=2, stepped=0)
    load_params(str(tmp_path), "latest", other.model)
    for x, y in zip(other.params, state.params):
        assert torch.equal(x, y)
    assert other.step == 0


def test_best_latest_policy_and_corrupt_fallback(tmp_path):
    events = []
    mgr = CheckpointManager(str(tmp_path), keep=2,
                            log=lambda e, **f: events.append((e, f)))
    s1 = _port_state(stepped=1)
    assert mgr.save(s1, 1.0, {"global_step": 1})
    s2 = _port_state(stepped=2)
    assert not mgr.save(s2, 0.5, {"global_step": 2})
    assert mgr.best_value == 1.0
    assert mgr.last_save["bytes"] > 0 and mgr.last_save["ms"] >= 0
    best = json.load(open(tmp_path / "best" / "infos.json"))
    latest = json.load(open(tmp_path / "latest" / "infos.json"))
    assert best["global_step"] == 1 and latest["global_step"] == 2
    assert latest["best_value"] == 1.0
    # a new manager recovers best_value from disk
    assert CheckpointManager(str(tmp_path)).best_value == 1.0

    got, infos = mgr.restore_latest(_port_state(seed=3, stepped=0))
    assert infos["ckpt_name"] == "latest"
    _equal_states(got, s2)

    # tear latest: restore logs it and falls back to the next candidate
    blob = (tmp_path / "latest" / "state.npz").read_bytes()
    (tmp_path / "latest" / "state.npz").write_bytes(blob[:-7] + b"garbage")
    with pytest.raises(CorruptCheckpointError):
        load_state(str(tmp_path), "latest", _port_state(stepped=0))
    got, infos = mgr.restore_latest(_port_state(seed=3, stepped=0))
    # best and the demoted latest.prev both hold step 1; best ranks first
    assert infos["ckpt_name"] == "best"
    _equal_states(got, s1)
    assert [f["name"] for e, f in events if e == "ckpt_corrupt"] == ["latest"]


def test_step_checkpoint_rotation(tmp_path):
    """keep=2 rotation, and the candidates ordered by training position
    (epoch, batch_index, global_step): an RL save whose step counter
    restarted at the handoff still ranks first."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _port_state(stepped=1)
    for step in (3, 6):                           # epoch 1, 8 steps
        mgr.save_step(state, step, {"epoch": 0, "batch_index": step})
    mgr.save(state, 1.0, {"epoch": 1, "batch_index": 0, "global_step": 8})
    for step in (9, 12):
        mgr.save_step(state, step, {"epoch": 1, "batch_index": step - 8})
    assert mgr.step_checkpoints() == [(9, "step_00000009"),
                                      (12, "step_00000012")]
    assert mgr._candidates() == ["step_00000012", "step_00000009",
                                 "latest", "best"]
    # the first RL epoch ends at RL step 3
    mgr.save(state, 0.5, {"epoch": 2, "batch_index": 0, "global_step": 3})
    assert mgr._candidates()[:2] == ["latest", "step_00000012"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX TrainState two Adam steps in, saved by the JAX manager."""
    model = CaptionModel(ModelConfig(**KW))
    tx = make_optimizer(TrainConfig(lr=1e-2), 10)
    feats, masks, labels, mask, w = _batch(0)
    jb = lambda b: (jax.tree.map(jnp.asarray, b[0]),  # noqa: E731
                    jax.tree.map(jnp.asarray, b[1]), jnp.asarray(b[2]),
                    jnp.asarray(b[3]), jnp.asarray(b[4]))
    state = create_train_state(model, tx, jb(_batch(0))[:3], seed=0)
    step = make_xe_step(model)
    for i in range(2):
        state, _ = step(state, *jb(_batch(i)))
    root = tmp_path_factory.mktemp("jax_ckpt")
    JaxManager(str(root)).save(jax.device_get(state), 0.5,
                               {"epoch": 1, "global_step": 2})
    return dict(model=model, state=state, root=str(root), step=step, jb=jb)


def _leaves_equal(want, got, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _leaves_equal(want[k], got[k], f"{path}/{k}")
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_decoder_matches_flax(jax_run):
    with open(os.path.join(jax_run["root"], "latest", "state.msgpack"),
              "rb") as f:
        blob = f.read()          # flax.serialization.to_bytes of the state
    want = serialization.msgpack_restore(blob)
    got = msgpack.restore(blob)
    _leaves_equal(want, got)
    with pytest.raises(msgpack.MsgpackError, match="truncated"):
        msgpack.restore(blob[:-3])


def test_jax_checkpoint_loads_into_the_port(jax_run):
    js = jax_run["state"]
    cfg = tcfg.ModelConfig(**KW)
    model = TorchCaptionModel(cfg, device="cpu")
    state = ttrain.create_train_state(
        model, ttrain.make_optimizer(tcfg.TrainConfig(lr=1e-2), 10))
    # the JAX manager's directory restores through the port's manager
    got, infos = CheckpointManager(jax_run["root"]).restore_latest(state)
    assert infos["global_step"] == 2 and infos["ckpt_name"] == "latest"
    assert got.step == int(js.step) == 2 and got.opt_state["count"] == 2
    names = [n for n, _ in model.named_parameters()]
    as_flax = lambda ts: state_dict_to_flax(cfg, dict(zip(names, ts)))  # noqa: E731
    adam = js.opt_state[1][0]
    for tree, want in ((as_flax(got.params), js.params),
                       (as_flax(got.opt_state["mu"]), adam.mu),
                       (as_flax(got.opt_state["nu"]), adam.nu)):
        _leaves_equal(jax.tree.map(np.asarray, want), tree)

    # one more XE step on both sides from the checkpoint
    b = _batch(5)
    js2, jm = jax_run["step"](js, *jax_run["jb"](b))
    got, tm = ttrain.make_xe_step(model)(got, *_tbatch(b))
    np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=TOL)
    want = jax.tree_util.tree_leaves_with_path(js2.params)
    have = dict(jax.tree_util.tree_leaves_with_path(as_flax(got.params)))
    for path, leaf in want:
        np.testing.assert_allclose(have[path], np.asarray(leaf), rtol=TOL,
                                   atol=TOL, err_msg=str(path))
    assert got.step == int(js2.step) == 3

    # params only (the handoff), from the JAX directory
    other = TorchCaptionModel(cfg, device="cpu")
    load_params(jax_run["root"], "best", other)
    _leaves_equal(jax.tree.map(np.asarray, js.params),
                  as_flax(list(other.parameters())))
