"""The five named presets (the JAX package's ``config/presets.py``).

:func:`get_preset` returns a preset's :class:`ModelConfig`, as the serving
path reads it; :func:`get_experiment` returns the whole
:class:`ExperimentConfig` with its data, XE, RL and eval settings.
"""

from __future__ import annotations

from cst_captioning_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    RLConfig,
    TrainConfig,
)

_MSVD_VOCAB = 4000
_MSRVTT_VOCAB = 9000

_MSVD_XE_MEANPOOL = ModelConfig(
    vocab_size=_MSVD_VOCAB,
    modalities=(("resnet", 2048),),
    encoder="meanpool",
    d_embed=512,
    d_hidden=512,
    max_len=30,
    max_frames=28,
)

_MSRVTT_XE_ATTENTION = ModelConfig(
    vocab_size=_MSRVTT_VOCAB,
    modalities=(("resnet", 2048), ("c3d", 500)),
    encoder="temporal_attention",
    d_embed=512,
    d_hidden=512,
    d_att=256,
    max_len=30,
    max_frames=28,
)

_XE = TrainConfig(loss="xe", lr=1e-4, epochs=50)
_MSVD_DATA = DataConfig(dataset="msvd", batch_size=64)
_MSRVTT_DATA = DataConfig(dataset="msrvtt", batch_size=64)

EXPERIMENTS: dict[str, ExperimentConfig] = {
    "msvd_xe_meanpool": ExperimentConfig(
        name="msvd_xe_meanpool", model=_MSVD_XE_MEANPOOL, data=_MSVD_DATA,
        train=_XE),
    "msrvtt_xe_attention": ExperimentConfig(
        name="msrvtt_xe_attention", model=_MSRVTT_XE_ATTENTION,
        data=_MSRVTT_DATA, train=_XE),
    "msrvtt_scst": ExperimentConfig(
        name="msrvtt_scst", model=_MSRVTT_XE_ATTENTION, data=_MSRVTT_DATA,
        train=_XE,
        rl=RLConfig(enabled=True, num_rollouts=1, baseline="greedy",
                    reward_cider_weight=1.0, reward_bleu4_weight=0.0,
                    lr=2e-5)),
    "msrvtt_cst_consensus": ExperimentConfig(
        name="msrvtt_cst_consensus", model=_MSRVTT_XE_ATTENTION,
        data=_MSRVTT_DATA, train=_XE,
        rl=RLConfig(enabled=True, num_rollouts=5, baseline="scb",
                    reward_cider_weight=1.0, reward_bleu4_weight=0.5,
                    lr=2e-5)),
    "msrvtt_eval_beam5": ExperimentConfig(
        name="msrvtt_eval_beam5", model=_MSRVTT_XE_ATTENTION,
        data=_MSRVTT_DATA, train=_XE,
        eval=EvalConfig(beam_size=5, max_len=30, split="test")),
}

PRESETS: dict[str, ModelConfig] = {k: v.model for k, v in EXPERIMENTS.items()}


def get_experiment(name: str) -> ExperimentConfig:
    try:
        return EXPERIMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(EXPERIMENTS)}"
        ) from None


def get_preset(name: str) -> ModelConfig:
    return get_experiment(name).model
