"""CaptionModel: encoder + LSTM decoder, split into :meth:`encode` (memory
bank, its attention projection, initial carry), :meth:`decode_step` (one
decoder step, shared by every decoding strategy) and the teacher-forced
unrolls (:meth:`decode_logits`, :meth:`teacher_force_logps`, and
:meth:`forward` from features). Each unroll is a Python loop over the T
steps of the same cell the decoders step."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from cst_captioning_tpu_torch.config import BOS_ID, ModelConfig
from cst_captioning_tpu_torch.decoding.common import selected_logprob
from cst_captioning_tpu_torch.device import resolve_device, torch_dtype
from cst_captioning_tpu_torch.models.decoder import Carry, DecoderCell
from cst_captioning_tpu_torch.models.encoders import (
    MeanPoolEncoder,
    TemporalAttentionEncoder,
    masked_mean,
)
from cst_captioning_tpu_torch.models.layers import Dense


@dataclass
class EncoderOutput:
    memory: torch.Tensor       # [B, M, E]
    memory_proj: torch.Tensor  # [B, M, d_att]
    memory_mask: torch.Tensor  # [B, M] float32
    carry: Carry               # initial LSTM carry, [B, H] leaves

    def take_batch(self, idx: torch.Tensor) -> "EncoderOutput":
        """Rows ``idx`` of every leaf (all are batch-major): the fused
        decode's compaction permutes the still-active columns into a dense
        prefix, and the bank follows so each row keeps its own memory."""
        t = lambda x: x.index_select(0, idx)  # noqa: E731
        return EncoderOutput(t(self.memory), t(self.memory_proj),
                             t(self.memory_mask),
                             tuple((t(c), t(h)) for c, h in self.carry))


def shift_right(labels: torch.Tensor) -> torch.Tensor:
    """[B, T] target tokens -> decoder inputs [B, T] starting with BOS."""
    bos = torch.full_like(labels[:, :1], BOS_ID)
    return torch.cat([bos, labels[:, :-1]], dim=1)


class CaptionModel(nn.Module):
    """Built on ``device`` (default the GPU; raises without one unless
    ``device="cpu"``) with random weights; :func:`convert.load_flax_params`
    loads a JAX parameter tree.

    :meth:`set_seq` (``parallel.seq_parallel.sp_model``) puts it on the
    row of a ``('data', 'seq')`` grid whose ranks each hold a shard of the
    frame axis: the mean-pool's sums, the temporal bank's attention
    softmax and the carry-init mean then reduce over it; the parameters
    are the same either way."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        if cfg.encoder == "meanpool":
            self.encoder = MeanPoolEncoder(cfg)
        else:
            self.encoder = TemporalAttentionEncoder(cfg)
        self.cell = DecoderCell(cfg)
        # the LSTM carry starts from the pooled memory
        self.init_c = nn.ModuleList([
            Dense(cfg.d_embed, cfg.d_hidden, dtype=dtype)
            for _ in range(cfg.num_layers)
        ])
        self.init_h = nn.ModuleList([
            Dense(cfg.d_embed, cfg.d_hidden, dtype=dtype)
            for _ in range(cfg.num_layers)
        ])
        self.seq = None     # the frame axis is whole here (set_seq)
        self.to(resolve_device(device))

    def set_seq(self, seq, seq_axis: str = "seq") -> None:
        """Shard the frame axis over the row ``seq`` (None: every frame
        here); ``cfg.seq_axis`` follows. A temporal bank is then
        frame-sharded, its softmax and carry-init mean collective; a
        mean-pooled bank is whole on every rank after the pooled sums,
        and its attention stays local."""
        if seq is not None and not self.cfg.seq_axis:
            self.cfg = dataclasses.replace(self.cfg, seq_axis=seq_axis)
        self.encoder.seq = seq
        self.seq = seq if self.cfg.encoder == "temporal_attention" else None
        self.cell.attention.seq = self.seq

    @property
    def device(self) -> torch.device:
        return self.cell.out_proj.weight.device

    def encode(self, feats: dict[str, torch.Tensor],
               masks: dict[str, torch.Tensor]) -> EncoderOutput:
        memory, mmask = self.encoder(feats, masks)
        memory_proj = self.cell.project_memory(memory)
        ctx0 = masked_mean(memory, mmask, 1, self.seq)
        carry = tuple(
            (torch.tanh(self.init_c[i](ctx0)), torch.tanh(self.init_h[i](ctx0)))
            for i in range(self.cfg.num_layers)
        )
        return EncoderOutput(memory, memory_proj, mmask, carry)

    def decode_step(self, carry: Carry, token: torch.Tensor,
                    enc: EncoderOutput):
        """-> (new carry, logits [B, V] float32)."""
        return self.cell(carry, token, enc.memory, enc.memory_proj,
                         enc.memory_mask)

    # ---- teacher forcing -----------------------------------------------------

    def _unroll(self, enc: EncoderOutput, labels: torch.Tensor, train: bool,
                generator, emit):
        if train and generator is None:
            raise ValueError("train=True needs a generator for dropout")
        inputs = shift_right(labels)
        carry = enc.carry
        out = []
        for t in range(labels.shape[1]):
            carry, logits = self.cell(
                carry, inputs[:, t], enc.memory, enc.memory_proj,
                enc.memory_mask, generator if train else None)
            out.append(emit(logits, t))
        return torch.stack(out, dim=1)

    def decode_logits(self, enc: EncoderOutput, labels: torch.Tensor,
                      train: bool = False,
                      generator: torch.Generator | None = None):
        """Teacher-forced logits [B, T, V] (float32) from an encoder output;
        ``logits[:, t]`` predicts ``labels[:, t]``. ``train`` applies
        dropout with masks drawn from ``generator``."""
        return self._unroll(enc, labels, train, generator,
                            lambda logits, t: logits)

    def teacher_force_logps(self, enc: EncoderOutput, labels: torch.Tensor,
                            train: bool = False,
                            generator: torch.Generator | None = None):
        """Per-position logprob of ``labels`` under teacher forcing, [B, T].
        Each step's logits are reduced to the target's logprob at once, so
        the [B, T, V] stack is never built."""
        return self._unroll(
            enc, labels, train, generator,
            lambda logits, t: selected_logprob(logits.float(), labels[:, t]))

    def forward(self, feats: dict[str, torch.Tensor],
                masks: dict[str, torch.Tensor], labels: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """-> logits [B, T, V] (float32); logits[:, t] predicts labels[:, t]."""
        return self.decode_logits(self.encode(feats, masks), labels, train,
                                  generator)
