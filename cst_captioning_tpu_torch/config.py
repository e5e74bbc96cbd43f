"""Configs and fixed token ids, for the PyTorch port.

The port's own copy of the part of ``cst_captioning_tpu/config/config.py``
that the serving, training and eval paths read: the special token ids,
:class:`ModelConfig`, the optimizer and RL fields of :class:`TrainConfig`
and :class:`RLConfig`, :class:`EvalConfig`, and :class:`ExperimentConfig`
that bundles them. Field names and defaults match the JAX package. Data
and mesh configs come with the slices that need them; the eval batch size
is the caller's argument (``Evaluator(batch_size=...)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
NUM_SPECIAL_TOKENS = 4


@dataclass(frozen=True)
class ModelConfig:
    """Caption model shape; field names and defaults match the JAX package."""

    vocab_size: int = 512
    # ordered (name, raw_dim) pairs
    modalities: tuple[tuple[str, int], ...] = (("resnet", 2048),)
    d_embed: int = 512          # word embedding + per-modality frame embedding
    d_hidden: int = 512         # LSTM hidden size
    encoder: str = "meanpool"   # "meanpool" | "temporal_attention"
    d_att: int = 256            # additive-attention projection dim
    num_layers: int = 1
    dropout: float = 0.5        # training only; decode runs without dropout
    max_len: int = 30           # max caption length incl. EOS
    max_frames: int = 60        # frame-axis padding length
    dtype: str = "bfloat16"     # compute dtype
    param_dtype: str = "float32"
    # "pallas" routes the teacher-forced attention context through the
    # additive-attention kernel (ops/attention.py, a CUDA kernel on the
    # GPU); "xla" keeps the plain PyTorch composite
    attention_impl: str = "xla"
    # "pallas" selects the decode kernels (ops/decode_stride.py for the
    # serving strides, ops/decode_step.py for the sampling loop; CUDA
    # kernels on the GPU); "xla" steps the decoder cell module itself
    decode_impl: str = "xla"
    decode_stride: int = 8      # decode steps per stride launch
    decode_compact: bool = True  # pack unfinished columns between strides

    def __post_init__(self):
        mods = self.modalities
        if isinstance(mods, Mapping):
            mods = mods.items()
        object.__setattr__(
            self, "modalities", tuple((str(k), int(v)) for k, v in mods)
        )
        if self.encoder not in ("meanpool", "temporal_attention"):
            raise ValueError(f"unknown encoder: {self.encoder!r}")
        if self.attention_impl not in ("xla", "pallas"):
            raise ValueError(
                f"unknown attention_impl: {self.attention_impl!r} "
                "(expected 'xla' or 'pallas')"
            )
        if self.decode_impl not in ("xla", "pallas"):
            raise ValueError(
                f"unknown decode_impl: {self.decode_impl!r} "
                "(expected 'xla' or 'pallas')"
            )
        if self.decode_stride < 1:
            raise ValueError(
                f"decode_stride {self.decode_stride} must be >= 1"
            )
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute dtype {self.dtype!r}")
        if self.param_dtype != "float32":
            raise ValueError(
                f"unsupported param dtype {self.param_dtype!r} (float32 only)"
            )


@dataclass(frozen=True)
class TrainConfig:
    """The optimization fields of the JAX ``TrainConfig`` that the XE step
    and the optimizer chain read."""

    optimizer: str = "adam"             # "adam" | "adamw" | "sgd" | "rmsprop"
    lr: float = 1e-4
    lr_decay: float = 0.5               # multiplicative decay factor
    lr_decay_every: int = 3             # epochs between decays (0 = constant)
    grad_clip: float = 5.0              # global-norm clip (0 = off)
    seed: int = 1234
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    loss: str = "xe"                    # "xe" | "wxe"

    def __post_init__(self):
        if self.loss not in ("xe", "wxe"):
            raise ValueError(
                f"unknown loss {self.loss!r} (expected 'xe' or 'wxe')")


@dataclass(frozen=True)
class RLConfig:
    """The CST / self-critical fields of the JAX ``RLConfig`` that the
    sequential RL step reads."""

    num_rollouts: int = 5               # K Monte-Carlo samples per clip
    baseline: str = "greedy"            # "greedy" | "scb" | "none"
    reward_cider_weight: float = 1.0
    reward_bleu4_weight: float = 0.0
    temperature: float = 1.0
    lr: float = 2e-5                    # RL phase LR (fresh optimizer)
    # host threads for the native consensus-reward scorer; 0 = all cores
    reward_threads: int = 0
    # sentence-BLEU4 (in [0, 1]) is scaled by this before mixing with
    # CIDEr-D (x10 scale): reward = w_c * CIDErD + w_b * BLEU4 * scale
    reward_bleu4_scale: float = 10.0
    # gradient accumulation over C slices of the K rollout axis in the
    # REINFORCE update (C divides K; 1 = one pass over all K*B rows)
    update_chunks: int = 1

    def __post_init__(self):
        if self.baseline not in ("greedy", "scb", "none"):
            raise ValueError(f"unknown baseline {self.baseline!r}")
        if self.update_chunks < 1 or self.num_rollouts % self.update_chunks:
            raise ValueError(
                f"update_chunks {self.update_chunks} must be >= 1 and "
                f"divide num_rollouts {self.num_rollouts}"
            )
        if self.reward_threads < 0:
            raise ValueError(
                f"reward_threads {self.reward_threads} must be >= 0 "
                "(0 = all cores)"
            )


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation: the decode (beam, greedy or NPAD) and the metric table."""

    beam_size: int = 5
    max_len: int = 30
    min_len: int = 0              # suppress EOS for the first N steps (0 = off)
    length_penalty: float = 0.0   # 0 = pure sum-logprob ranking
    split: str = "test"
    # selector names understood by metrics.scorer.CaptionScorer
    metrics: tuple[str, ...] = ("Bleu", "ROUGE_L", "METEOR_approx", "CIDEr",
                                "CIDEr-D")
    results_json: str = ""
    # "lanes" = beams on decode lanes (the beam-step kernel at
    # decode_impl="pallas"), "reference" = beams flattened into the batch
    beam_impl: str = "lanes"
    # NPAD mode: > 0 decodes greedy + this many noise-perturbed lanes and
    # answers with the best-sum-logprob lane instead of beam search
    npad_lanes: int = 0
    npad_temperature: float = 1.0
    npad_seed: int = 0
    # decode batch i+1 while a worker pool tokenizes batch i's captions
    pipelined: bool = True
    score_workers: int = 4        # tokenizer threads feeding the drain

    def __post_init__(self):
        if self.beam_impl not in ("lanes", "reference"):
            raise ValueError(
                f"eval.beam_impl must be 'lanes' or 'reference', got "
                f"{self.beam_impl!r}"
            )
        if self.npad_lanes < 0:
            raise ValueError(
                f"eval.npad_lanes {self.npad_lanes} must be >= 0 (0 = off)"
            )
        if self.npad_lanes and self.npad_temperature <= 0:
            raise ValueError(
                f"eval.npad_temperature {self.npad_temperature} must be > 0"
            )
        if self.score_workers < 1:
            raise ValueError(
                f"eval.score_workers {self.score_workers} must be >= 1"
            )


@dataclass(frozen=True)
class ExperimentConfig:
    """A named recipe: model, XE, RL and eval settings."""

    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
