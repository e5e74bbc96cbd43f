"""Feature encoders: each yields a memory bank ``[B, M, E]`` and its mask.

- :class:`MeanPoolEncoder`: masked mean over frames per modality, one
  memory slot per modality.
- :class:`TemporalAttentionEncoder`: per-frame embeddings, all modalities
  concatenated along the frame axis.

Under sequence parallelism (``seq`` set) each rank holds a shard of every
modality's frames: the mean-pool's sums run over the row (the pooled
bank is then the same on every rank), and the temporal bank stays
frame-sharded, its slots this rank's frames.
"""

from __future__ import annotations

import torch
from torch import nn

from cst_captioning_tpu_torch.config import ModelConfig
from cst_captioning_tpu_torch.device import torch_dtype
from cst_captioning_tpu_torch.models.layers import Dense


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int,
                row=None) -> torch.Tensor:
    """Mean over ``dim`` counting only mask==1 positions. ``row``: the seq
    row ``dim`` is sharded over (sequence parallelism); the numerator and
    the count are summed over it, in one float32 all-reduce, before the
    divide, so the result is the unsharded mean."""
    mask = mask.to(x.dtype)
    num = (x * mask.unsqueeze(-1)).sum(dim)
    den = mask.sum(dim)
    if row is not None:
        from cst_captioning_tpu_torch.parallel.seq_parallel import seq_sum

        both = seq_sum(torch.cat([num.float(), den.float().unsqueeze(-1)],
                                 dim=-1), row)
        num, den = both[..., :-1].to(x.dtype), both[..., -1].to(x.dtype)
    return num / torch.clamp(den, min=1.0).unsqueeze(-1)


class _Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.embed = nn.ModuleDict({
            name: Dense(dim, cfg.d_embed, dtype=self.dtype,
                        param_dtype=torch_dtype(cfg.param_dtype))
            for name, dim in cfg.modalities
        })
        # the seq row the frame axis is sharded over (None: all here)
        self.seq = None


class MeanPoolEncoder(_Encoder):
    def forward(self, feats: dict[str, torch.Tensor],
                masks: dict[str, torch.Tensor]):
        """feats[name]: [B, F, D] -> (memory [B, n_mod, E], mask [B, n_mod])."""
        slots = []
        for name, _ in self.cfg.modalities:
            pooled = masked_mean(feats[name].to(self.dtype), masks[name], 1,
                                 self.seq)
            slots.append(torch.tanh(self.embed[name](pooled)))
        memory = torch.stack(slots, dim=1)
        mmask = torch.ones(memory.shape[:2], dtype=torch.float32,
                           device=memory.device)
        return memory, mmask


class TemporalAttentionEncoder(_Encoder):
    def forward(self, feats: dict[str, torch.Tensor],
                masks: dict[str, torch.Tensor]):
        """-> (memory [B, sum_F, E], mask [B, sum_F]): one slot per frame."""
        banks, bmasks = [], []
        for name, _ in self.cfg.modalities:
            emb = self.embed[name](feats[name].to(self.dtype))
            banks.append(torch.tanh(emb))
            bmasks.append(masks[name])
        memory = torch.cat(banks, dim=1)
        mmask = torch.cat(bmasks, dim=1).to(torch.float32)
        # padded slots are zeroed, so they add nothing even unmasked
        memory = memory * mmask.unsqueeze(-1).to(memory.dtype)
        return memory, mmask
