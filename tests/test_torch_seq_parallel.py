"""The port's sequence parallelism (``parallel/seq_parallel.py``) on
``('data', 'seq')`` grids of gloo ranks (``test_torch_sp_child.py``):
(1 x 2) and (2 x 2), float32.

The JAX tests' model (``tests/test_seq_parallel.py:30-72``: V=20, B=4,
F=16, T=6, E=H=12, A=8, dropout 0, both encoders, ragged masks, so some
rows have a fully masked shard), its weights carried across by
``convert.py``:

- the forward, the XE step (seq only and data x seq) and the RL update
  (chunks 1 and 3, K=3, one invalid row, lr 1e-2) against the JAX
  single-device functions at the JAX SP tests' tolerances; beam-3 tokens
  and the meanpool greedy tokens equal JAX's;
- the temporal greedy and sampled tokens equal the port's own one-rank
  decode (the JAX SP oracle is red there), and every rank of a row
  returns the same tokens; the long frame axis (F=512 at seq 2);
- planted fault (a): ``seq_enter``'s backward as the identity fails the
  XE-step params gate.

The Trainer on a (2 x 2) grid: an XE epoch at dropout 0.5 with
validation against the port's 2-rank data-parallel trainer (the JAX
trainer test's bounds), the CST epoch's rollouts equal to it, an SCST
epoch's rollouts (greedy lane included) equal to the one-rank run's, the
grid evaluator's beam-3 captions and metrics equal to the one-rank
evaluator's on a wrap-padded batch; the refusals with the JAX package's
messages, and planted fault (b): a rank fed another data coordinate's
rows makes the row check raise on every rank.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
    MeshConfig as JaxMeshConfig,
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from cst_captioning_tpu.config.presets import get_preset as jax_preset
from cst_captioning_tpu.decoding import beam_search as jax_beam
from cst_captioning_tpu.decoding import greedy_decode as jax_greedy
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.rl.scst import make_rl_update as jax_rl_update
from cst_captioning_tpu.train import (
    create_train_state as jax_state,
    make_optimizer as jax_opt,
)
from cst_captioning_tpu.train.steps import make_xe_step as jax_xe_step
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch.config import (
    EvalConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
)
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.data import (
    CaptionDataset,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.decoding import greedy_decode
from cst_captioning_tpu_torch.eval.evaluator import Evaluator
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.presets import get_experiment
from cst_captioning_tpu_torch.rl import make_rl_decode
from cst_captioning_tpu_torch.train.trainer import Trainer
from test_torch_dp_child import finish_ok, start
from test_torch_sp_child import _recording

torch.set_num_threads(1)

SP_CHILD = os.path.join(os.path.dirname(__file__), "test_torch_sp_child.py")
V, B, F, T, K = 20, 4, 16, 6, 3
FWD_TOL = dict(rtol=2e-5, atol=1e-5)     # tests/test_seq_parallel.py:89
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)   # :162-164, :228-230
# tests/test_trainer_integration.py's seq-devices test
TR_LOSS_TOL, TR_PARAM_TOL = 1e-4, dict(rtol=2e-2, atol=2e-3)
RL_TOL = dict(rtol=1e-2, atol=2e-3)      # tests/test_rl.py:159
ENCODERS = ("temporal_attention", "meanpool")
GRIDS = {"1x2": (2, 2), "2x2": (4, 2)}   # name: (world, seq)


def _model_kw(enc):
    return dict(vocab_size=V, modalities=(("resnet", 10), ("c3d", 6)),
                d_embed=12, d_hidden=12, d_att=8, encoder=enc, dropout=0.0,
                max_len=T, max_frames=F, dtype="float32")


def _case(enc):
    """tests/test_seq_parallel.py's setup and the JAX single-device
    references."""
    jm = JaxCaptionModel(JaxModelConfig(**_model_kw(enc)))
    rng = np.random.default_rng(0)
    feats = {"resnet": rng.normal(size=(B, F, 10)).astype(np.float32),
             "c3d": rng.normal(size=(B, F, 6)).astype(np.float32)}
    masks = {k: (np.arange(F)[None, :] < rng.integers(3, F + 1, size=(B, 1))
                 ).astype(np.float32) for k in feats}
    labels = rng.integers(4, V, size=(B, T)).astype(np.int32)
    jf = jax.tree.map(jnp.asarray, feats)
    jmk = jax.tree.map(jnp.asarray, masks)
    mask = np.ones((B, T), np.float32)
    weights = np.ones((B,), np.float32)
    state = jax_state(jm, jax_opt(JaxTrainConfig(lr=1e-2, grad_clip=5.0), 10),
                      (jf, jmk, jnp.asarray(labels)), seed=3)
    params = state.params
    xe_s, xe_m = jax_xe_step(jm)(state, jf, jmk, jnp.asarray(labels),
                                 jnp.asarray(mask), jnp.asarray(weights))
    rng = np.random.default_rng(5)
    samples = rng.integers(2, V, size=(K, B, T)).astype(np.int32)
    adv = rng.normal(size=(K, B)).astype(np.float32)
    valid = np.asarray([1, 1, 1, 0], np.float32)
    rl_s, rl_m = jax_rl_update(jm)(state, jf, jmk, jnp.asarray(samples),
                                   jnp.asarray(adv), jnp.asarray(valid))
    fparams = jax.tree.map(np.asarray, params)
    return dict(
        model=_model_kw(enc), params=fparams, feats=feats, masks=masks,
        labels=labels.astype(np.int64), mask=mask, weights=weights,
        samples=samples, adv=adv, valid=valid, T=T,
        want=dict(
            logits=np.asarray(jm.apply(params, jf, jmk, jnp.asarray(labels))),
            xe=(float(xe_m["loss"]), xe_s.params),
            rl=(float(rl_m["rl_loss"]), rl_s.params),
            beam=np.asarray(jax_beam(jm, params, jf, jmk, beam_size=3,
                                     max_len=T)[0]),
            greedy=np.asarray(jax_greedy(jm, params, jf, jmk,
                                         max_len=T)[0])))


def _long_case():
    rng = np.random.default_rng(7)
    return dict(feats={"resnet": rng.normal(size=(2, 512, 10)).astype(
        np.float32), "c3d": rng.normal(size=(2, 512, 6)).astype(np.float32)},
        masks={k: np.ones((2, 512), np.float32) for k in ("resnet", "c3d")},
        T=T)


# ---- the trainer's corpus and config ----------------------------------------

TF = 8     # the trainer corpus's frames: 4 a rank at seq 2
MODAL = (("resnet", 8), ("c3d", 6))
CORPUS = dict(num_videos=24, num_topics=3, vocab_words=20,
              modalities=dict(MODAL), max_frames=TF, seed=11,
              caption_style="template", splits=(0.75, 0.125))


def _trainer_args(root, tp, nv, params, **mesh):
    ov = dict(model__vocab_size=nv, model__modalities=MODAL,
              model__d_embed=12, model__d_hidden=12, model__d_att=6,
              model__encoder="temporal_attention", model__dropout=0.5,
              model__max_len=8, model__max_frames=TF,
              model__dtype="float32", data__batch_size=4,
              data__seq_per_vid=2, train__epochs=1,
              train__log_every_steps=1, rl__num_rollouts=3, rl__epochs=1,
              train__seed=3, **mesh)
    tmp = os.path.join(root, "_".join(f"{v}" for v in mesh.values()))
    os.makedirs(tmp, exist_ok=True)
    return dict(preset="msrvtt_cst_consensus", overrides=ov,
                info_json=tp["info_json"],
                features={n: tp[n] for n, _ in MODAL}, max_frames=TF,
                params=params, tmp=tmp, ckpt_dir=os.path.join(tmp, "ck"),
                rl=True)


def _cli_args(root, tp, sp_args) -> dict:
    """cli.train's and cli.eval's argv on a (1 x 2) grid: the trainer
    test's model, one XE epoch without dropout, then beam-3 on val."""
    os.makedirs(root)
    ov = {k: v for k, v in sp_args["overrides"].items()
          if not k.startswith(("mesh__", "rl__"))}
    ov.update(model__dropout=0.0, mesh__num_devices=2, mesh__seq_devices=2,
              train__ckpt_dir=str(root / "ck"))
    common = ["--preset", "msrvtt_xe_attention", "--info-json",
              tp["info_json"], "--device", "cpu"]
    for n, _ in MODAL:
        common += ["--feature", f"{n}={tp[n]}"]
    for k, v in ov.items():
        common += ["--set", f"{k}={v!r}"]
    return {"train": common + ["--dist-init", f"file://{root / 'tr.init'}",
                               "--log-jsonl", str(root / "cli.jsonl")],
            "eval": common + ["--dist-init", f"file://{root / 'ev.init'}",
                              "--ckpt-dir", str(root / "ck"), "--split",
                              "val", "--set", "eval__beam_size=3",
                              "--set", "eval__max_len=8",
                              "--results-json",
                              str(root / "results.json")]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the file, started together: the step, decode and
    eval cases on a (1 x 2) and a (2 x 2) grid, the (2 x 2) Trainer, and
    the 2-rank data-parallel Trainer it is held to; the JAX references
    are computed while the ranks run."""
    root = tmp_path_factory.mktemp("sp")
    tp = make_synthetic_dataset(str(root / "corpus"), **CORPUS)
    nv = len(json.load(open(tp["info_json"]))["vocab"])
    mkw = dict(vocab_size=nv, modalities=MODAL, d_embed=12, d_hidden=12,
               d_att=6, encoder="temporal_attention", max_len=8,
               max_frames=TF, dtype="float32")
    from cst_captioning_tpu_torch.convert import random_flax_params

    start_params = random_flax_params(ModelConfig(**mkw), 3)
    sp_args = _trainer_args(str(root), tp, nv, start_params,
                            mesh__num_devices=4, mesh__seq_devices=2)
    dp_args = _trainer_args(str(root), tp, nv, start_params,
                            mesh__num_devices=2)
    handles = {
        "trainer": start("sp_trainer", sp_args, root, 4, 240,
                         script=SP_CHILD),
        "dp_trainer": start("trainer", dp_args, root, 2, 240),
        "cli": start("cli", _cli_args(root / "cli", tp, sp_args), root, 2,
                     240, script=SP_CHILD)}
    cases = {enc: _case(enc) for enc in ENCODERS}
    child = {enc: {k: v for k, v in c.items() if k != "want"}
             for enc, c in cases.items()}
    for name, (world, seq) in GRIDS.items():
        args = dict(seq=seq, cases=child)
        if name == "1x2":
            args["long"] = _long_case()
        os.makedirs(root / name)
        handles[name] = start("sp", args, root / name, world, 240,
                              script=SP_CHILD)
    out = {k: finish_ok(h, k) for k, h in handles.items()}
    return dict(out=out, cases=cases, root=root, tp=tp, nv=nv, mkw=mkw,
                start_params=start_params, sp_args=sp_args,
                dp_args=dp_args)


def _port_model(case):
    return load_flax_params(CaptionModel(ModelConfig(**case["model"]),
                                         device="cpu"), case["params"])


def _close(port_params, jax_params, model_kw, tol):
    """The port's parameter list (model order) against a JAX tree."""
    m = CaptionModel(ModelConfig(**model_kw), device="cpu")
    with torch.no_grad():
        for p, v in zip(m.parameters(), port_params):
            p.copy_(torch.from_numpy(v))
    got = state_dict_to_flax(m.cfg, m.state_dict())
    want = jax.tree.map(np.asarray, jax.device_get(jax_params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, err_msg=str(path), **tol)


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _rows(results, key):
    """Per data coordinate in order, one rank's ``key(result)``, after
    checking every rank of its row returned the same."""
    per_row = {}
    for r in results:
        d, _ = r["cell"]
        per_row.setdefault(d, []).append(key(r))
    for vals in per_row.values():
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
    return [per_row[d][0] for d in sorted(per_row)]


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("enc", ENCODERS)
def test_sp_forward_matches_jax_single_device(runs, grid, enc):
    res = runs["out"][grid]
    got = np.concatenate(_rows(res, lambda r: r[enc]["logits"]))
    np.testing.assert_allclose(got, runs["cases"][enc]["want"]["logits"],
                               **FWD_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("enc", ENCODERS)
def test_sp_xe_step_matches_jax_single_device(runs, grid, enc):
    """The XE step on the grid: seq only (1 x 2) and data x seq (2 x 2);
    every rank ends with the same parameters."""
    case = runs["cases"][enc]
    loss, params = case["want"]["xe"]
    res = runs["out"][grid]
    for r in res:
        np.testing.assert_allclose(r[enc]["xe"][0], loss, rtol=1e-5)
        _bitwise(r[enc]["xe"][1], res[0][enc]["xe"][1])
    _close(res[0][enc]["xe"][1], params, case["model"], PARAM_TOL)
    counts = res[0][enc]["xe"][2]
    # one flat reduction of the gradients over the row a step
    assert counts["row_grads"] == 1
    if enc == "temporal_attention":
        # a teacher-forced step: the max and the (num, den) sum per
        # attention call, seq_enter's sum per call in the backward and
        # the carry-init mean
        assert counts["seq_max"] == counts["seq_enter"] == T
        assert counts["seq_sum"] == T + 1
    else:
        # meanpool: the pooled sums only; the bank is whole on every rank
        assert counts["seq_sum"] == 2
        assert "seq_max" not in counts and "seq_enter" not in counts


@pytest.mark.parametrize("enc", ENCODERS)
def test_planted_seq_enter_identity_fails_the_xe_gate(runs, enc):
    """Planted fault (a): with ``seq_enter``'s backward the identity, the
    replicated path gets exact plus this rank's partial, and the params
    gate fails (temporal bank); at meanpool no tensor enters frame-local
    work, so the step is unchanged."""
    case = runs["cases"][enc]
    got = runs["out"]["1x2"][0][enc]["xe_planted"][1]
    if enc == "temporal_attention":
        with pytest.raises(AssertionError):
            _close(got, case["want"]["xe"][1], case["model"], PARAM_TOL)
    else:
        _close(got, case["want"]["xe"][1], case["model"], PARAM_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("enc", ENCODERS)
def test_sp_rl_update_matches_jax_single_device(runs, grid, enc):
    case = runs["cases"][enc]
    loss, params = case["want"]["rl"]
    res = runs["out"][grid]
    for chunks in (1, 3):
        for r in res:
            np.testing.assert_allclose(r[enc][f"rl{chunks}"][0], loss,
                                       rtol=1e-5)
            _bitwise(r[enc][f"rl{chunks}"][1], res[0][enc][f"rl{chunks}"][1])
        _close(res[0][enc][f"rl{chunks}"][1], params, case["model"],
               PARAM_TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("enc", ENCODERS)
def test_sp_beam_search_equals_jax(runs, grid, enc):
    got = np.concatenate(_rows(runs["out"][grid], lambda r: r[enc]["beam"]))
    np.testing.assert_array_equal(got, runs["cases"][enc]["want"]["beam"])


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("enc", ENCODERS)
def test_sp_greedy_and_samples_equal_one_rank(runs, grid, enc):
    """Greedy and sampled tokens (fused and two-loop) equal the port's
    one-rank decode, the same on every rank of a row; at meanpool the
    greedy tokens also equal the JAX single-device decode."""
    case = runs["cases"][enc]
    res = runs["out"][grid]
    model = _port_model(case)
    f, m = _t(case["feats"]), _t(case["masks"])
    want_g = greedy_decode(model, f, m, max_len=T)[0].numpy()
    got = np.concatenate(_rows(res, lambda r: r[enc]["greedy"]))
    np.testing.assert_array_equal(got, want_g)
    if enc == "meanpool":
        np.testing.assert_array_equal(got, case["want"]["greedy"])
    for name, fused in (("fused", True), ("two_loop", False)):
        g1, s1 = make_rl_decode(model, 2, max_len=T, fused=fused)(
            model, f, m, 7)
        g = np.concatenate(_rows(res, lambda r: r[enc][f"dec_{name}"][0]))
        s = np.concatenate(_rows(res, lambda r: r[enc][f"dec_{name}"][1]),
                           axis=1)
        np.testing.assert_array_equal(g, g1.numpy())
        np.testing.assert_array_equal(s, s1.numpy())
    g, s = res[0][enc]["dec_greedy_only"]
    np.testing.assert_array_equal(g, s)


def test_sp_long_frame_axis_equals_one_rank(runs):
    """F=512 at seq 2 (256 frames a rank): greedy equals one rank's."""
    case = runs["cases"]["temporal_attention"]
    lc = _long_case()
    want = greedy_decode(_port_model(case), _t(lc["feats"]), _t(lc["masks"]),
                         max_len=T)[0].numpy()
    res = runs["out"]["1x2"]
    assert [r["long_frames"] for r in res] == [256, 256]
    for r in res:
        np.testing.assert_array_equal(r["long"], want)


def test_grid_cells_follow_the_jax_reshape(runs):
    assert [r["cell"] for r in runs["out"]["2x2"]] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert runs["out"]["2x2"][0]["shape"] == {"data": 2, "seq": 2}
    assert [r["cell"] for r in runs["out"]["1x2"]] == [(0, 0), (0, 1)]


# ---- the trainer, SCST, the evaluator -----------------------------------------


def _events(path, name):
    return [e for e in map(json.loads, open(path)) if e["event"] == name]


def test_grid_xe_epoch_matches_data_parallel_trainer(runs):
    """The (2 x 2) XE epoch at dropout 0.5 against the 2-rank
    data-parallel trainer: a rank's dropout masks are its data
    coordinate's, so the two runs differ only in summation order."""
    sp, dp = runs["out"]["trainer"], runs["out"]["dp_trainer"]
    assert [r["cell"] for r in sp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["local_batch"] for r in sp} == {2}
    sl = [e["loss"] for e in _events(
        os.path.join(runs["sp_args"]["tmp"], "log.jsonl"), "xe_step")]
    dl = [e["loss"] for e in _events(
        os.path.join(runs["dp_args"]["tmp"], "log.jsonl"), "xe_step")]
    assert len(sl) == len(dl) > 2
    np.testing.assert_allclose(sl, dl, rtol=TR_LOSS_TOL)
    for r in sp:
        _bitwise(r["xe_params"], sp[0]["xe_params"])
        assert r["captions"] == sp[0]["captions"]
    for a, b in zip(sp[0]["xe_params"], dp[0]["xe_params"]):
        np.testing.assert_allclose(a, b, **TR_PARAM_TOL)
    assert abs(sp[0]["val"] - dp[0]["val"]) <= 1e-6


def test_grid_cst_epoch_matches_data_parallel_trainer(runs):
    sp, dp = runs["out"]["trainer"], runs["out"]["dp_trainer"]
    for r in sp:
        _bitwise(r["rl_params"], sp[0]["rl_params"])
    assert len(sp[0]["cst_rollouts"]) == len(dp[0]["rollouts"]) > 1
    for a, b, d0, d1 in zip(sp[0]["cst_rollouts"], sp[2]["cst_rollouts"],
                            dp[0]["rollouts"], dp[1]["rollouts"]):
        np.testing.assert_array_equal(a, d0)
        np.testing.assert_array_equal(b, d1)
    for a, b in zip(sp[0]["rl_params"], dp[0]["rl_params"]):
        np.testing.assert_allclose(a, b, **RL_TOL)


def test_grid_scst_rollouts_equal_one_rank(runs, tmp_path):
    """The greedy-baseline SCST epoch on the grid, from the start weights,
    against the port's one-rank run: every batch's greedy lane and
    rollouts equal, token for token."""
    a = runs["sp_args"]
    ov = {k: v for k, v in a["overrides"].items()
          if not k.startswith("mesh__")}
    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=str(tmp_path / "ck"), rl__baseline="greedy", **ov)
    ds = {s: CaptionDataset(a["info_json"], a["features"], s, TF)
          for s in ("train", "val")}
    rollouts = []
    from cst_captioning_tpu_torch.rl import scst as scst_mod

    orig = _recording(rollouts)
    try:
        tr = Trainer(cfg, ds["train"], ds["val"], device="cpu",
                     params=runs["start_params"])
        assert tr.mesh is None
        tr.epoch = tr.xe_epochs = 1
        tr.train_rl()
        tr.close()
    finally:
        scst_mod.SCSTTrainer._score = orig
    sp = runs["out"]["trainer"]
    assert len(rollouts) == len(sp[0]["scst_rollouts"]) > 1
    for j, one in enumerate(rollouts):
        assert one.shape[0] == 4          # greedy lane + K=3
        got = np.concatenate(_rows(sp, lambda r: r["scst_rollouts"][j]),
                             axis=1)
        np.testing.assert_array_equal(got, one)
    for x, p in zip(sp[0]["scst_params"], tr.state.params):
        np.testing.assert_allclose(x, p.detach().numpy(), **RL_TOL)


def test_grid_evaluator_equals_one_rank(runs):
    """Beam-3 on the grid (batch 3 wrap-padded to 4 over the data axis)
    equals the one-rank evaluator: captions and metrics; rank 0 alone
    writes the results."""
    sp = runs["out"]["trainer"]
    caps, metrics, bs, local, params = sp[0]["eval"]
    assert bs == 4 and local == 2
    model = CaptionModel(ModelConfig(**runs["mkw"]), device="cpu")
    with torch.no_grad():
        for p, v in zip(model.parameters(), params):
            p.copy_(torch.from_numpy(v))
    a = runs["sp_args"]
    ds = CaptionDataset(a["info_json"], a["features"], "val", TF)
    want = Evaluator(model, ds, EvalConfig(beam_size=3, max_len=8,
                                           metrics=("CIDEr-D", "Bleu")),
                     batch_size=3).evaluate()
    for r in sp:
        assert r["eval"][0] == want["captions"] == caps
        assert r["eval"][1] == want["metrics"] == metrics
    tmp = a["tmp"]
    assert os.path.exists(os.path.join(tmp, "eval.rank0.json"))
    assert not any(os.path.exists(os.path.join(tmp, f"eval.rank{k}.json"))
                   for k in (1, 2, 3))


def test_grid_seam_gathers_one_rank_a_row(runs):
    """A drained pipelined epoch's seam on the grid: the global batch's
    rows once each (a row's ranks hold the same), and each rank's rows
    back from it."""
    for r in runs["out"]["trainer"]:
        ids, rows, back, matches = r["seam"]
        assert ids == ["v0", "v1", "v2", "v3"]
        assert rows == [[100 * i + k for i in range(4)] for k in range(3)]
        assert back and matches


def test_planted_row_fed_other_videos_raises_on_every_rank(runs):
    """Planted fault (b): rank 1 collates data coordinate 1's rows; the
    epoch's row check raises on all four ranks, naming the rule."""
    for r in runs["out"]["trainer"]:
        assert r["planted_b"] is not None
        assert "seq row 0" in r["planted_b"]
        assert "same rows" in r["planted_b"]


# ---- refusals, with the JAX package's messages ------------------------------------


def _jax_raises(fn):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return str(e.value)


def test_refusals_match_jax_messages(runs, tmp_path):
    def both(**kw):
        mine = _jax_raises(lambda: get_experiment(
            "msrvtt_cst_consensus").override(**kw))
        theirs = _jax_raises(lambda: jax_preset(
            "msrvtt_cst_consensus").override(**kw))
        assert mine == theirs

    both(model__attention_impl="pallas", mesh__seq_devices=2)
    both(model__decode_impl="pallas", mesh__seq_devices=2)
    both(train__comm_dtype="bf16", mesh__seq_devices=2)
    both(train__rl_topology="decoupled", mesh__seq_devices=2)
    assert _jax_raises(lambda: MeshConfig(seq_devices=2, mp_devices=2)) == \
        _jax_raises(lambda: JaxExperimentConfig(
            mesh=JaxMeshConfig(seq_devices=2, mp_devices=2)))
    # max_frames: the JAX trainer's message, on its 8 virtual devices
    jcfg = jax_preset("msrvtt_xe_attention").override(
        model__max_frames=27, mesh__num_devices=4, mesh__seq_devices=2,
        train__ckpt_dir=str(tmp_path / "j"))
    want = _jax_raises(lambda: JaxTrainer(jcfg, None, None, use_mesh=True))
    assert _jax_raises(lambda: ExperimentConfig(
        model=ModelConfig(max_frames=27),
        mesh=MeshConfig(seq_devices=2))) == want
    # the batch the data axis does not divide, on the (2 x 2) grid
    jcfg = jax_preset("msrvtt_xe_attention").override(
        data__batch_size=3, mesh__num_devices=4, mesh__seq_devices=2,
        train__ckpt_dir=str(tmp_path / "j"))
    want = _jax_raises(lambda: JaxTrainer(jcfg, None, None, use_mesh=True))
    for r in runs["out"]["trainer"]:
        assert r["odd_batch"] == want
        assert r["degraded"].startswith(
            "degraded-mesh continuation does not support the "
            "('data','seq') mesh")


def test_cli_train_and_eval_on_a_grid(runs):
    """cli.train and cli.eval with mesh.seq_devices=2 under RANK /
    WORLD_SIZE: one row of two ranks; the eval's captions
    and metrics equal the one-rank evaluator's on the trained weights;
    rank 0 alone writes the results."""
    from cst_captioning_tpu_torch.ckpt import load_params

    res = runs["out"]["cli"]
    assert [r["cell"] for r in res] == [(0, 0), (0, 1)]
    assert [r["row"] for r in res] == [2, 2]
    assert res[0]["steps"] == res[1]["steps"] > 0
    assert res[0]["captions"] == res[1]["captions"]
    root = runs["root"] / "cli"
    model = CaptionModel(ModelConfig(**runs["mkw"]), device="cpu")
    load_params(str(root / "ck"), "best", model)
    a = runs["sp_args"]
    ds = CaptionDataset(a["info_json"], a["features"], "val", TF)
    want = Evaluator(model, ds, EvalConfig(beam_size=3, max_len=8),
                     batch_size=4).evaluate()
    assert res[0]["captions"] == want["captions"]
    assert res[0]["metrics"] == want["metrics"]
    assert json.load(open(root / "results.json"))["metrics"] == \
        want["metrics"]


@pytest.mark.parametrize("data_axis", ["", "data"])
def test_sp_batch_specs_match_jax(data_axis):
    """The port's specs name the JAX package's axes, dim for dim
    (``sp_batch_specs``; ``sp_batch_shardings``' XE tuple)."""
    from cst_captioning_tpu.parallel import sp_batch_specs as jax_specs
    from cst_captioning_tpu_torch.parallel import (
        sp_batch_shardings,
        sp_batch_specs,
    )

    jcfg = JaxModelConfig(**_model_kw("temporal_attention"))
    cfg = ModelConfig(**_model_kw("temporal_attention"))
    for got, want in zip(sp_batch_specs(cfg, data_axis),
                         jax_specs(jcfg, data_axis)):
        assert {k: tuple(v) for k, v in want.items()} == got
    f, m, *rows = sp_batch_shardings(None, cfg)
    assert (f, m) == sp_batch_specs(cfg, "data")
    assert rows == [("data",)] * 4


def test_place_takes_a_grid_ranks_block():
    """``shard_frames`` cuts every modality's frame axis to the rank's
    block (its seq coordinate's), numpy arrays and tensors alike, and
    leaves the rows (host-local already) whole; frames that do not divide
    over the row raise."""
    from cst_captioning_tpu_torch.parallel.seq_parallel import shard_frames
    from cst_captioning_tpu_torch.train.mesh import DataMesh, GridMesh

    dev = torch.device("cpu")
    x = np.arange(B * F * 10).reshape(B, F, 10)
    feats = {"resnet": x, "c3d": torch.from_numpy(x[..., :6].copy())}
    for s in range(2):
        grid = GridMesh(rank=2 + s, world=4, device=dev,
                        data=DataMesh("data", 1, 2, dev),
                        row=DataMesh("seq", s, 2, dev))
        got = shard_frames(grid, feats)
        frames = slice(s * F // 2, (s + 1) * F // 2)
        np.testing.assert_array_equal(got["resnet"], x[:, frames])
        assert isinstance(got["c3d"], torch.Tensor)
        np.testing.assert_array_equal(got["c3d"].numpy(),
                                      x[:, frames, :6])
    with pytest.raises(ValueError, match="do not divide"):
        shard_frames(grid, {"resnet": x[:, :F - 1]})
