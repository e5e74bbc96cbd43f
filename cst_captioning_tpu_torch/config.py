"""Configs and fixed token ids, for the PyTorch port.

The port's own copy of ``cst_captioning_tpu/config/config.py``: the
special token ids, :class:`ModelConfig`, :class:`DataConfig`,
:class:`TrainConfig`, :class:`RLConfig`, :class:`EvalConfig`,
:class:`MeshConfig` and :class:`ExperimentConfig` with its JSON round trip
and ``section__field`` overrides. Field names and defaults match the JAX
package; ``DataConfig.feature_files`` name the port's feature files
(``data/dataset.py``) in place of h5 files.

Every field of the JAX config is ported, with the JAX package's checks
on it: among them the health monitor's knobs (``train.health*``,
``peer_timeout_s``, ``dcn_stall_s``), both elastic modes
(``train.elastic`` "strict" or "degraded", and ``elastic_regrow``: the
degraded-mesh continuation and grow-back of ``train/trainer.py``), the
data mesh (``mesh.num_devices``: one rank a device, ``train/mesh.py``),
the gradient-communication knobs (``train.comm_*``,
``parallel/comms.py``), sequence parallelism (``mesh.seq_devices``,
``model.seq_axis``: the ``('data', 'seq')`` grid of ranks,
``parallel/seq_parallel.py``) and model parallelism (``mesh.mp_devices``:
the ``('data', 'mp')`` grid, ``ops/decode_mp.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping

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
    # the mesh axis a frame-sharded memory bank runs over ("" = one
    # device's frame axis)
    seq_axis: str = ""
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
        if self.decode_impl == "pallas" and self.seq_axis:
            # the kernels' softmax is one device's; a frame-sharded bank
            # needs the collective one
            raise ValueError(
                "decode_impl='pallas' cannot run with a frame-sharded "
                "memory bank (seq_axis set) — the kernel's attention "
                "softmax is not collective"
            )


@dataclass(frozen=True)
class DataConfig:
    """Dataset wiring; ``feature_files`` are (modality, path of the port's
    ``<modality>.npy`` feature file) pairs."""

    dataset: str = "synthetic"          # "msvd" | "msrvtt" | "synthetic"
    feature_files: tuple[tuple[str, str], ...] = ()
    info_json: str = ""                 # vocab + splits + tokenized captions
    consensus_weights: str = ""         # WXE per-caption weights (npz)
    cider_df: str = ""                  # precomputed CIDEr-D document freqs
    batch_size: int = 64
    seq_per_vid: int = 1                # caption rows sampled per video (XE)
    shuffle_seed: int = 0
    prefetch: int = 2                   # batches staged ahead on the device
    # keep every clip's padded features in host memory after the first
    # read; cached arrays come back read-only
    cache_features: bool = False

    def __post_init__(self):
        if isinstance(self.feature_files, Mapping):
            object.__setattr__(
                self, "feature_files",
                tuple((str(k), str(v)) for k, v in self.feature_files.items()))
        else:
            object.__setattr__(
                self, "feature_files",
                tuple((str(k), str(v)) for k, v in self.feature_files))


@dataclass(frozen=True)
class TrainConfig:
    """The optimization loop and its run plumbing (the JAX package's
    ``TrainConfig``)."""

    optimizer: str = "adam"             # "adam" | "adamw" | "sgd" | "rmsprop"
    lr: float = 1e-4
    lr_decay: float = 0.5               # multiplicative decay factor
    lr_decay_every: int = 3             # epochs between decays (0 = constant)
    grad_clip: float = 5.0              # global-norm clip (0 = off)
    epochs: int = 30                    # XE phase total
    seed: int = 1234
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    loss: str = "xe"                    # "xe" | "wxe"
    # per-step JSONL events every N steps (0 = epoch summaries only)
    log_every_steps: int = 0
    eval_every_epochs: int = 1
    ckpt_dir: str = "checkpoints"
    resume: str = ""                    # "", "auto", or a checkpoint dir
    # torch.profiler Chrome traces of profile_steps steps after the first,
    # under <profile_dir>/xe and /rl (utils/profiling.py)
    profile_dir: str = ""
    profile_steps: int = 10
    # raise FloatingPointError at the first module whose output is not
    # finite, with autograd's anomaly mode on (train/trainer.py)
    debug_nans: bool = False
    # spans, metrics and the run report (obs/); obs_dir "" = <ckpt_dir>/obs
    obs: bool = False
    obs_dir: str = ""
    # mid-epoch step_<n> checkpoint interval in steps (0 = epoch ends and
    # SIGTERM saves only)
    ckpt_every_steps: int = 0
    keep_ckpts: int = 3                 # keep-last-K rotation of step_*
    # divergence policy: "off" | "skip_batch" | "rollback" | "abort"
    on_divergence: str = "skip_batch"
    # flag a finite loss > factor * median(recent window); 0 = off
    spike_factor: float = 0.0
    # "adaptive": the bound follows the loss EWMA's moments, clamped to
    # [spike_factor_min, spike_factor] x median (resilience/adaptive.py)
    spike_mode: str = "fixed"
    spike_factor_min: float = 1.5
    max_rollbacks: int = 2              # rollback budget per run
    health: bool = False
    health_dir: str = ""
    health_interval_s: float = 0.5
    peer_timeout_s: float = 5.0
    health_misses: int = 2
    health_sim_hosts: int = 0
    elastic: str = "strict"
    elastic_regrow: bool = True
    dcn_stall_s: float = 2.0
    comm_bucket_mb: float = 4.0
    comm_dtype: str = "f32"
    comm_overlap: bool = False
    # flight-recorder ring capacity in steps (0 = off; needs obs) and the
    # online anomaly detector over its streams (obs/recorder.py, anomaly.py)
    recorder_steps: int = 0
    anomaly: bool = False
    rl_topology: str = "sync"

    def __post_init__(self):
        if self.loss not in ("xe", "wxe"):
            raise ValueError(
                f"unknown loss {self.loss!r} (expected 'xe' or 'wxe')")
        if self.on_divergence not in ("off", "skip_batch", "rollback",
                                      "abort"):
            raise ValueError(
                f"unknown on_divergence policy {self.on_divergence!r} "
                "(expected 'off', 'skip_batch', 'rollback', or 'abort')")
        if (self.ckpt_every_steps < 0 or self.keep_ckpts < 1
                or self.max_rollbacks < 0):
            raise ValueError(
                "resilience knobs out of range: ckpt_every_steps >= 0, "
                "keep_ckpts >= 1, max_rollbacks >= 0 required "
                f"(got {self.ckpt_every_steps}, {self.keep_ckpts}, "
                f"{self.max_rollbacks})")
        if self.eval_every_epochs < 1:
            raise ValueError(
                f"eval_every_epochs {self.eval_every_epochs} must be >= 1")
        if self.recorder_steps < 0:
            raise ValueError(
                f"recorder_steps {self.recorder_steps} must be >= 0 "
                "(0 = flight recorder off)")
        if self.spike_mode not in ("fixed", "adaptive"):
            raise ValueError(
                f"unknown spike_mode {self.spike_mode!r} "
                "(expected 'fixed' or 'adaptive')")
        if self.spike_mode == "adaptive":
            if self.spike_factor <= 0:
                raise ValueError(
                    "spike_mode='adaptive' needs spike_factor > 0 — the "
                    "factor is the adaptive bound's ceiling clamp")
            if not 0 < self.spike_factor_min <= self.spike_factor:
                raise ValueError(
                    f"spike_factor_min {self.spike_factor_min} must be in "
                    f"(0, spike_factor={self.spike_factor}]")
        if self.rl_topology not in ("sync", "decoupled"):
            raise ValueError(
                f"unknown rl_topology {self.rl_topology!r} "
                "(expected 'sync' or 'decoupled')")
        if self.elastic not in ("strict", "degraded"):
            raise ValueError(
                f"unknown elastic mode {self.elastic!r} "
                "(expected 'strict' or 'degraded')")
        if self.health_interval_s <= 0 or self.peer_timeout_s <= 0:
            raise ValueError(
                "health knobs out of range: health_interval_s > 0 and "
                f"peer_timeout_s > 0 required (got {self.health_interval_s}, "
                f"{self.peer_timeout_s})")
        if self.health_sim_hosts < 0:
            raise ValueError(
                f"health_sim_hosts {self.health_sim_hosts} must be >= 0 "
                "(0 = the real process count)")
        if self.comm_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"unknown comm_dtype {self.comm_dtype!r} "
                "(expected 'f32' or 'bf16')")
        if self.comm_bucket_mb < 0:
            raise ValueError(
                f"comm_bucket_mb {self.comm_bucket_mb} must be >= 0 "
                "(0 = one message per leaf)")


@dataclass(frozen=True)
class RLConfig:
    """The CST / self-critical phase (the JAX package's ``RLConfig``)."""

    enabled: bool = False
    num_rollouts: int = 5               # K Monte-Carlo samples per clip
    baseline: str = "greedy"            # "greedy" | "scb" | "none"
    reward_cider_weight: float = 1.0
    reward_bleu4_weight: float = 0.0
    temperature: float = 1.0
    lr: float = 2e-5                    # RL phase LR (fresh optimizer)
    epochs: int = 20                    # RL phase total
    init_from: str = ""                 # XE checkpoint dir to start from
    # True: the two-stage epoch, update(i-2) -> decode(i) -> score(i-1);
    # False: decode -> score -> update per batch
    pipelined: bool = True
    # host threads for the native consensus-reward scorer; 0 = all cores
    reward_threads: int = 0
    # sentence-BLEU4 (in [0, 1]) is scaled by this before mixing with
    # CIDEr-D (x10 scale): reward = w_c * CIDErD + w_b * BLEU4 * scale
    reward_bleu4_scale: float = 10.0
    # gradient accumulation over C slices of the K rollout axis in the
    # REINFORCE update (C divides K; 1 = one pass over all K*B rows)
    update_chunks: int = 1
    # train.rl_topology="decoupled" (rl/async_scst.py): rollout batches in
    # flight between actor and learner, and the learner updates a rollout
    # may lag at consumption before it is dropped and decoded again
    # (depth 1 with bound 0 is the strict sequential schedule)
    rollout_depth: int = 2
    staleness_bound: int = 1
    # train.rl_topology="decoupled" on a mesh of several ranks: the share
    # of the ranks that decode (the first round(n * actor_fraction), at
    # least one and at most n - 1, each side clamped to a divisor of the
    # batch; parallel/submesh.py); the rest learn. A world of one rank
    # runs the one-device ring, whatever the fraction
    actor_fraction: float = 0.5
    # online SCST from served traffic (rl/online.py): served requests per
    # learner batch, and learner updates between publishes into the service
    online_batch_size: int = 4
    swap_every: int = 1

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
class MeshConfig:
    """The device mesh: one rank a device (``train/mesh.py``)."""

    data_axis: str = "data"
    # 0 = the initialized world size (1 without a launcher); N > 1 must
    # equal it (``train.mesh.make_mesh`` raises, saying to launch N
    # processes)
    num_devices: int = 0
    seq_devices: int = 1
    mp_devices: int = 1

    def __post_init__(self):
        if self.seq_devices < 1:
            raise ValueError(
                f"mesh.seq_devices {self.seq_devices} must be >= 1 "
                "(1 = no sequence parallelism)")
        if self.mp_devices < 1:
            raise ValueError(
                f"mesh.mp_devices {self.mp_devices} must be >= 1 "
                "(1 = no model parallelism)")
        if self.seq_devices > 1 and self.mp_devices > 1:
            # both want the second mesh axis (the JAX package's message)
            raise ValueError(
                "mesh.mp_devices > 1 cannot compose with the "
                "sequence-parallel ('seq_devices > 1') path yet — "
                "pick one second mesh axis")


@dataclass(frozen=True)
class ExperimentConfig:
    """A named recipe: model, data, XE, RL, eval and mesh settings."""

    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self):
        # the JAX package's cross-section checks, with its messages
        sp = self.mesh.seq_devices > 1
        if self.model.attention_impl == "pallas" and sp:
            # the sequence-parallel path's softmax is collective; the
            # kernel's is one device's
            raise ValueError(
                "attention_impl='pallas' is not implemented for the "
                "sequence-parallel ('seq_devices > 1') path; use one or the "
                "other")
        if self.model.decode_impl == "pallas" and sp:
            raise ValueError(
                "decode_impl='pallas' is not implemented for the "
                "sequence-parallel ('seq_devices > 1') path; use one or the "
                "other")
        if sp and self.model.max_frames % self.mesh.seq_devices:
            raise ValueError(
                f"model.max_frames {self.model.max_frames} must be "
                f"divisible by mesh.seq_devices {self.mesh.seq_devices}")
        if sp and (self.train.comm_dtype != "f32"
                   or self.train.comm_overlap):
            raise ValueError(
                "train.comm_dtype='bf16' / train.comm_overlap are not "
                "implemented for the sequence-parallel ('seq_devices > 1') "
                "path: its gradients are computed outside shard_map and "
                "never ride a grad allreduce")
        if self.train.rl_topology == "decoupled":
            if self.rl.rollout_depth < 1:
                raise ValueError(
                    f"rl.rollout_depth {self.rl.rollout_depth} must be >= 1 "
                    "for train.rl_topology='decoupled'")
            if self.rl.staleness_bound < 0:
                raise ValueError(
                    f"rl.staleness_bound {self.rl.staleness_bound} must be "
                    ">= 0 (0 = strict on-policy consumption)")
            if not 0.0 < self.rl.actor_fraction < 1.0:
                raise ValueError(
                    f"rl.actor_fraction {self.rl.actor_fraction} must be in "
                    "(0, 1) — both submeshes need at least one device's "
                    "share")
            if sp:
                # the JAX refusal: the SP decode and update run over the
                # whole row, which a split of 'data' under it would cut
                raise ValueError(
                    "train.rl_topology='decoupled' is not implemented for "
                    "the sequence-parallel ('seq_devices > 1') path")
        if self.train.comm_overlap and self.rl.update_chunks < 2:
            # overlap hides a chunk's all-reduce behind the next chunk's
            # backward: one chunk leaves nothing to hide behind
            raise ValueError(
                "train.comm_overlap requires rl.update_chunks >= 2 (the "
                f"chunk boundary is the overlap seam; got "
                f"{self.rl.update_chunks})")
        self._check_mp()
        if self.rl.online_batch_size < 1:
            raise ValueError(
                f"rl.online_batch_size {self.rl.online_batch_size} must be "
                ">= 1 (served requests per online learner batch)")
        if self.rl.swap_every < 1:
            raise ValueError(
                f"rl.swap_every {self.rl.swap_every} must be >= 1 (learner "
                "updates between param publishes into the serving engine)")

    def _check_mp(self) -> None:
        """The model-parallel grid's divisibility (the JAX package's
        checks and messages)."""
        mp = self.mesh.mp_devices
        if mp <= 1:
            return
        if self.model.vocab_size % mp:
            raise ValueError(
                f"mesh.mp_devices {mp} must divide model.vocab_size "
                f"{self.model.vocab_size} (the vocab head and embedding "
                "shard in equal slices)")
        if self.model.d_hidden % mp:
            raise ValueError(
                f"mesh.mp_devices {mp} must divide model.d_hidden "
                f"{self.model.d_hidden} (the LSTM gate matrices shard in "
                "equal columns)")
        if self.mesh.num_devices and self.mesh.num_devices % mp:
            raise ValueError(
                f"mesh.mp_devices {mp} must divide mesh.num_devices "
                f"{self.mesh.num_devices} (the mesh is a dense data x mp "
                "grid)")

    # ---- serialization ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        def build(tp, val):
            if val is None:
                return tp()
            fields = {f.name for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in val.items():
                if k not in fields:
                    raise KeyError(f"{tp.__name__}: unknown field {k!r}")
                if isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            name=d.get("name", "experiment"),
            model=build(ModelConfig, d.get("model")),
            data=build(DataConfig, d.get("data")),
            train=build(TrainConfig, d.get("train")),
            rl=build(RLConfig, d.get("rl")),
            eval=build(EvalConfig, d.get("eval")),
            mesh=build(MeshConfig, d.get("mesh")),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def override(self, **dotted: Any) -> "ExperimentConfig":
        """Apply ``section__field=value`` overrides:
        ``cfg.override(model__d_hidden=1024, rl__enabled=True)``."""
        out = self
        for key, value in dotted.items():
            section, _, fname = key.partition("__")
            if not fname:
                out = dataclasses.replace(out, **{section: value})
                continue
            sub = getattr(out, section)
            out = dataclasses.replace(
                out, **{section: dataclasses.replace(sub, **{fname: value})}
            )
        return out
