"""The paper's two-stage recipe through the port's CLIs on a tiny corpus
(as ``tests/test_cli_recipe.py`` runs the JAX package's), on the CPU:

    stage 1: WXE training (consensus-weighted cross-entropy)
    stage 2: CST from the stage-1 checkpoint (``rl__init_from``, --skip-xe)
    then:    beam eval of the stage-2 checkpoint, and beam eval of a
             checkpoint the JAX package wrote (``--jax-ckpt``), whose
             metric table equals the JAX evaluator's on the same params.

Also: the decoupled RL topology through ``--set``, ``--debug-nans``
reaching the trainer, and the default device is the GPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.ckpt import CheckpointManager as JaxManager
from cst_captioning_tpu.config.presets import get_preset as jax_preset
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.preprocess import compute_consensus_weights
from cst_captioning_tpu.eval.evaluator import evaluate_split as jax_evaluate
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import create_train_state
from cst_captioning_tpu_torch.cli.eval import main as eval_main
from cst_captioning_tpu_torch.cli.train import main as train_main
from cst_captioning_tpu_torch.data import make_synthetic_dataset

torch.set_num_threads(1)

DIMS = {"resnet": 12}
KW = dict(num_videos=16, num_topics=3, vocab_words=20, modalities=DIMS,
          max_frames=4, seed=13)


@pytest.fixture(scope="module")
def recipe_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recipe")
    paths = make_synthetic_dataset(str(root), **KW)
    info = json.load(open(paths["info_json"]))
    tok = {v["id"]: [c.split() for c in v["captions"]]
           for v in info["videos"] if v["split"] == "train"}
    w_path = str(root / "consensus_weights.npz")
    np.savez(w_path, **compute_consensus_weights(tok))
    paths["consensus_weights"] = w_path
    paths["vocab_size"] = len(info["vocab"])
    paths["root"] = root
    return paths


def _common(paths):
    return [
        "--info-json", paths["info_json"],
        "--feature", f"resnet={paths['resnet']}",
        "--set", f"model__vocab_size={paths['vocab_size']}",
        "--set", "model__modalities=(('resnet',12),)",
        "--set", "model__d_embed=12", "--set", "model__d_hidden=12",
        "--set", "model__d_att=8", "--set", "model__max_len=8",
        "--set", "model__max_frames=4", "--set", "model__dtype='float32'",
        "--set", "data__batch_size=8", "--set", "data__seq_per_vid=3",
        "--device", "cpu",
    ]


def test_two_stage_recipe_via_clis(recipe_data, tmp_path):
    xe_ckpt = str(tmp_path / "xe")
    rl_ckpt = str(tmp_path / "rl")
    log1 = str(tmp_path / "stage1.jsonl")
    log2 = str(tmp_path / "stage2.jsonl")

    train_main([
        "--preset", "msrvtt_xe_attention", *_common(recipe_data),
        "--set", "train__loss='wxe'", "--set", "train__lr=5e-3",
        "--set",
        f"data__consensus_weights='{recipe_data['consensus_weights']}'",
        "--set", "train__epochs=3", "--set", "train__eval_every_epochs=3",
        "--log-jsonl", log1, "--set", f"train__ckpt_dir='{xe_ckpt}'",
    ])
    ev1 = [json.loads(line) for line in open(log1)]
    xe_losses = [e["loss"] for e in ev1 if e["event"] == "xe_epoch"]
    assert len(xe_losses) == 3 and xe_losses[-1] < xe_losses[0]
    assert os.path.exists(os.path.join(xe_ckpt, "best", "state.npz"))

    trainer = train_main([
        "--preset", "msrvtt_scst", *_common(recipe_data), "--skip-xe",
        "--set", f"rl__init_from='{xe_ckpt}'",
        "--set", "rl__epochs=2", "--set", "rl__num_rollouts=3",
        "--set", "train__eval_every_epochs=1",
        "--log-jsonl", log2, "--set", f"train__ckpt_dir='{rl_ckpt}'",
    ])
    ev2 = [json.loads(line) for line in open(log2)]
    assert [e for e in ev2 if e["event"] == "handoff"], "no XE->RL handoff"
    rl = [e for e in ev2 if e["event"] == "rl_epoch"]
    assert len(rl) == 2 and all(np.isfinite(e["reward"]) for e in rl)
    assert trainer.rl_epochs == 2 and trainer.xe_epochs == 0
    assert os.path.exists(os.path.join(rl_ckpt, "latest", "state.npz"))

    res = str(tmp_path / "results.json")
    result = eval_main([
        "--preset", "msrvtt_eval_beam5", *_common(recipe_data),
        "--ckpt-dir", rl_ckpt, "--ckpt-name", "latest", "--split", "test",
        "--set", "eval__beam_size=3", "--set", "eval__max_len=8",
        "--results-json", res,
    ])
    saved = json.load(open(res))
    assert saved["captions"] == result["captions"] and saved["captions"]
    assert all(np.isfinite(v) for v in saved["metrics"].values())


def test_decoupled_topology_via_the_train_cli(recipe_data, tmp_path):
    """``train.rl_topology="decoupled"`` and its ring knobs pass through
    ``--set`` as in the JAX CLI: the RL epoch runs the actor/learner ring
    (depth 3 / bound 1 drops and recounts) and checkpoints."""
    from cst_captioning_tpu_torch import obs

    log = str(tmp_path / "rl.jsonl")
    steps = obs.counter("rl.learner.steps").value
    trainer = train_main([
        "--preset", "msrvtt_cst_consensus", *_common(recipe_data),
        "--skip-xe", "--set", "rl__epochs=1", "--set", "rl__num_rollouts=3",
        "--set", "train__rl_topology='decoupled'",
        "--set", "rl__rollout_depth=3", "--set", "rl__staleness_bound=1",
        "--log-jsonl", log, "--set", f"train__ckpt_dir='{tmp_path / 'ck'}'",
    ])
    assert trainer.cfg.train.rl_topology == "decoupled"
    assert (trainer.cfg.rl.rollout_depth, trainer.cfg.rl.staleness_bound) \
        == (3, 1)
    ev = [json.loads(line) for line in open(log)]
    rl = [e for e in ev if e["event"] == "rl_epoch"]
    assert len(rl) == 1 and np.isfinite(rl[0]["reward"])
    # every step went through the ring's learner
    assert obs.counter("rl.learner.steps").value - steps == rl[0]["steps"]
    assert trainer.rl_epochs == 1
    assert os.path.exists(str(tmp_path / "ck" / "latest" / "state.npz"))


def test_eval_of_a_jax_checkpoint_matches_the_jax_evaluator(recipe_data,
                                                            tmp_path):
    """Params from the JAX package (its CheckpointManager's save) through
    ``--jax-ckpt``: the same metric table as the JAX evaluator's."""
    jcfg = jax_preset("msrvtt_eval_beam5").override(
        model__vocab_size=recipe_data["vocab_size"],
        model__modalities=(("resnet", 12),), model__d_embed=12,
        model__d_hidden=12, model__d_att=8, model__max_len=8,
        model__max_frames=4, model__dtype="float32", eval__beam_size=3,
        eval__max_len=8)
    model = CaptionModel(jcfg.model)
    feats = {"resnet": jnp.zeros((2, 4, 12))}
    masks = {"resnet": jnp.ones((2, 4))}
    state = create_train_state(model, make_optimizer(jcfg.train, 4),
                               (feats, masks, jnp.zeros((2, 8), jnp.int32)),
                               seed=5)
    JaxManager(str(tmp_path / "jax")).save(jax.device_get(state), 0.1,
                                           {"epoch": 1})
    jds = JaxDataset(recipe_data["info_json"], {"resnet": _h5(recipe_data,
                                                             tmp_path)},
                     "test", 4)
    want = jax_evaluate(model, state.params, jds, jcfg.eval, batch_size=8)
    got = eval_main([
        "--preset", "msrvtt_eval_beam5", *_common(recipe_data),
        "--jax-ckpt", str(tmp_path / "jax" / "best"), "--split", "test",
        "--set", "eval__beam_size=3", "--set", "eval__max_len=8",
        "--results-json", str(tmp_path / "res.json"),
    ])
    assert got["captions"] == want["captions"]
    assert got["metrics"] == want["metrics"]


def _h5(paths, tmp_path):
    """The corpus's resnet features as the JAX package's h5 file."""
    import h5py

    from cst_captioning_tpu_torch.data import FeatureStore

    store = FeatureStore(paths["resnet"], max_frames=64)
    out = str(tmp_path / "resnet.h5")
    with h5py.File(out, "w") as h5:
        for vid in store.keys():
            start, n = store._index[vid]
            h5.create_dataset(vid, data=np.asarray(
                store._frames[start:start + n]))
    return out


def test_debug_nans_flag_reaches_the_trainer(recipe_data, tmp_path,
                                            monkeypatch):
    """``--debug-nans`` sets ``train.debug_nans``: the trainer trains with
    anomaly mode and the module hooks on, and the CLI's ``close()`` turns
    both off again."""
    from cst_captioning_tpu_torch.train import trainer as trainer_mod

    seen = {}
    real = trainer_mod.Trainer.train_xe

    def train_xe(self, *a, **kw):
        seen["anomaly"] = torch.is_anomaly_enabled()
        seen["hooks"] = self._nan_hooks is not None
        return real(self, *a, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "train_xe", train_xe)
    tr = train_main(["--preset", "msrvtt_xe_attention",
                     *_common(recipe_data), "--debug-nans",
                     "--set", "train__epochs=1",
                     "--set", f"train__ckpt_dir='{tmp_path}'"])
    assert tr.cfg.train.debug_nans and tr.xe_epochs == 1
    assert seen == {"anomaly": True, "hooks": True}
    assert not torch.is_anomaly_enabled() and tr._nan_hooks is None


def test_cli_default_device_is_the_gpu(recipe_data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _common(recipe_data) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--preset", "msrvtt_xe_attention", *args,
                    "--set", f"train__ckpt_dir='{tmp_path}'"])
